"""Rank bodies of ``tests/test_torch_split_forward.py``. ``run_cases`` runs
in every process of one gloo group of 8 that
``repro_torch.launch.mesh.run_ranks`` spawns: each case builds the (2, 4)
("data", "model") mesh, runs a prefill and a few slot decode steps through
the port's single-device model and through the same model split over the
mesh (``Model(cfg, mesh=mesh)`` on its shards of the parameters), and
checks on every rank that its logits and its cache shard match; rank 0
saves what it found for the test process to compare with the JAX package.
A case that raises is saved as its traceback, so that only its own test
fails."""
import dataclasses
import os
import pickle
import traceback

import torch

from repro_torch.configs import get_config
from repro_torch.launch.mesh import in_mesh, make_test_mesh
from repro_torch.models import model as model_mod
from repro_torch.models.model import Model
from repro_torch.parallel import sharding
from repro_torch.tree import flatten

AXES = ("data", "model")
RTOL = 1e-5  # the split model's logits and cache against the single-device model's
# An int8 cache: the split's sums run in another order than one device's, so
# a value a float32 ulp from a rounding tie may take the next code. Where a
# code differs (by one, at fewer than INT8_TIE_SHARE of the codes; its bf16
# scale by at most one bf16 ulp), the logits are held to INT8_TIE_RTOL.
INT8_TIE_SHARE = 1e-3
INT8_TIE_RTOL = 1e-3
BF16_ULP = 2.0 ** -7


def save(out: str, rank: int, obj) -> None:
    with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(obj, f)


def load(out: str, rank: int):
    with open(os.path.join(out, f"rank{rank}.pkl"), "rb") as f:
        return pickle.load(f)


def run_cases(rank, world, cases, out):
    """Run ``cases`` [(name, body name, args)] in turn; rank 0 saves name →
    what the body returned (or {"error": traceback})."""
    found = {}
    for name, body, args in cases:
        try:
            found[name] = globals()[body](rank, world, *args)
        except Exception:
            found[name] = {"error": traceback.format_exc()}
    if rank == 0:
        save(out, rank, found)


def cfg_of(arch, over):
    return dataclasses.replace(get_config(arch).reduced(), **over)


def rel_err(got, want) -> float:
    """max |got - want| over max |want| (0 for two zero tensors)."""
    got, want = got.double(), want.double()
    scale = want.abs().max().item()
    return (got - want).abs().max().item() / scale if scale else (got - want).abs().max().item()


def _run(model, params, tokens, max_seq, steps, legacy=False):
    """A prefill and a slot decode of each column of ``steps`` [B, n] →
    (logits of each call, the cache leaves after each call, the cache)."""
    logits, cache = model.prefill(params, tokens, max_seq)
    outs, caches = [logits.clone()], [[t.clone() for t in flatten(cache)[0]]]
    model_mod.LEGACY_CACHE_SCAN = legacy
    try:
        for i in range(steps.shape[1]):
            logits, cache = model.decode_step(params, cache, steps[:, i:i + 1])
            outs.append(logits.clone())
            caches.append([t.clone() for t in flatten(cache)[0]])
    finally:
        model_mod.LEGACY_CACHE_SCAN = False
    return outs, caches, cache


def split_forward(rank, world, arch, over, params_np, tokens_np, steps_np, max_seq):
    """The split prefill and decodes of one case against the single-device
    model's on every rank: the whole logits within ``RTOL``, each cache leaf
    the rank's slice of the single-device leaf (``cache_axes`` and the
    rules' spec) within ``RTOL``, and the ``LEGACY_CACHE_SCAN`` decodes
    bitwise equal to the default ones on both models. Rank 0 returns the
    single-device and split logits, the errors and the split's layout."""
    mesh = make_test_mesh((2, 4), AXES, device="cpu")
    assert in_mesh(mesh)
    cfg = cfg_of(arch, over)
    tokens, steps = torch.from_numpy(tokens_np).long(), torch.from_numpy(steps_np).long()
    single = Model(cfg, device="cpu")
    params = single.params_from_reference(params_np)
    split = Model(cfg, device="cpu", mesh=mesh)
    shards = split.shard_params(params)
    with torch.no_grad():
        want, want_caches, cache1 = _run(single, params, tokens, max_seq, steps)
        got, got_caches, cache_s = _run(split, shards, tokens, max_seq, steps)
        want_l, want_lc, _ = _run(single, params, tokens, max_seq, steps, legacy=True)
        got_l, got_lc, _ = _run(split, shards, tokens, max_seq, steps, legacy=True)
    specs = sharding.tree_specs(cache1, single.cache_axes(cache1), split.rules)
    spec_leaves = flatten(specs, is_leaf=sharding.is_spec)[0]
    errs = {"logits": max(rel_err(g, w) for g, w in zip(got, want)), "cache": 0.0,
            "codes_off": 0, "codes": 0, "scale_ulps": 0.0}
    for wc, gc_ in zip(want_caches, got_caches):
        for w, g, sp in zip(wc, gc_, spec_leaves):
            mine = w[sharding.shard_slices(sp, w.shape, mesh)]
            assert g.shape == mine.shape, (g.shape, mine.shape, sp)
            if g.dtype == torch.int8:
                off = (g.int() - mine.int()).abs()
                assert int(off.max()) <= 1, "an int8 code more than one apart"
                errs["codes_off"] += int((off > 0).sum())
                errs["codes"] += off.numel()
            elif g.dtype == torch.bfloat16:  # an int8 cache's scales
                d = ((g.float() - mine.float()).abs() / mine.float().abs().clamp(min=1e-30))
                errs["scale_ulps"] = max(errs["scale_ulps"], float(d.max()) / BF16_ULP)
            else:
                errs["cache"] = max(errs["cache"], rel_err(g.float(), mine.float()))
    all_errs = [None] * world
    torch.distributed.all_gather_object(all_errs, errs)
    assert errs["cache"] <= RTOL and errs["scale_ulps"] <= 1.0, errs
    assert errs["codes_off"] <= INT8_TIE_SHARE * max(errs["codes"], 1), errs
    # the logits are whole on every rank: a tie on any rank's shard reaches them
    ties = any(e["codes_off"] or e["scale_ulps"] for e in all_errs)
    assert errs["logits"] <= (INT8_TIE_RTOL if ties else RTOL), (errs, all_errs)
    for a, b in ((want, want_l), (got, got_l)):
        assert all(torch.equal(x, y) for x, y in zip(a, b)), "legacy decode differs"
    for a, b in ((want_caches, want_lc), (got_caches, got_lc)):
        assert all(torch.equal(x, y) for ca, cb in zip(a, b) for x, y in zip(ca, cb))
    found = {"errs": all_errs, "ties": ties, "want": [t.numpy() for t in want], "got": [t.numpy() for t in got],
             "kv": {k: tuple(v.shape) for k, v in cache_s.items() if k in ("k", "v")},
             "fallbacks": sorted(set(split.rules.fallbacks))}
    return found if rank == 0 else None
