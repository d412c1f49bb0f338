"""Rank body of ``tests/test_torch_profiler.py``'s mesh case: every
process of one gloo group (``repro_torch.launch.mesh.run_ranks``) counts a
10-layer loop that calls one ``parallel/collectives.py`` function a layer,
once for each of the four, under the op counter, and saves what it
counted (its traceback if it raised) for the test process."""
import os
import pickle
import traceback

import torch

from repro_torch.core.op_cost import analyze
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.parallel import collectives as col

AXIS = "model"


def save(out: str, rank: int, obj) -> None:
    with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(obj, f)


def load(out: str, rank: int):
    with open(os.path.join(out, f"rank{rank}.pkl"), "rb") as f:
        return pickle.load(f)


def collectives_per_layer(rank, world, out, layers):
    """{JAX op name: (counts, bytes by op, total bytes, payload of one
    call's result)} over ``layers`` layers of tanh(x @ w) and one
    collective each on a (2, 4) ("data", "model") mesh."""
    try:
        mesh = make_test_mesh((2, 4), ("data", "model"), device="cpu")
        p = col.group_size(mesh, AXIS)
        x = torch.randn(16, 64, generator=torch.Generator().manual_seed(rank))
        ws = torch.randn(layers, 64, 64) / 8
        ops = {
            "all-reduce": (lambda y: col.all_reduce(y, mesh, AXIS), x.numel() * 4),
            "all-gather": (lambda y: col.all_gather(y, mesh, AXIS)[:16], p * x.numel() * 4),
            "all-to-all": (lambda y: col.all_to_all(y, mesh, AXIS), x.numel() * 4),
            "collective-permute": (lambda y: col.ring_shift(y, mesh, AXIS), x.numel() * 4),
        }
        found = {}
        for op, (call, payload) in ops.items():
            def stack(y, ws):
                for w in ws.unbind(0):
                    y = call(torch.tanh(y @ w))
                return y

            cost = analyze(stack, x, ws)
            found[op] = (dict(cost.collective_counts), dict(cost.collective_by_op),
                         cost.collective_bytes, payload)
    except Exception:
        found = {"error": traceback.format_exc()}
    save(out, rank, found)
