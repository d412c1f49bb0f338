"""Rank bodies of ``tests/test_torch_train_mesh.py``. ``run_cases`` runs in
every process of one gloo group that ``repro_torch.launch.mesh.run_ranks``
spawns and runs the cases in turn: each builds its mesh over the group's
first ranks (the others skip it), imports torch and the port only, and
returns what it found; rank 0 saves it for the test process to compare
with the JAX package, and a case that raises is saved as its traceback, so
that only its own test fails. Every rank of a mesh runs the same body, as
every rank of a data-parallel trainer runs the same step."""
import dataclasses
import os
import pickle
import traceback

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.launch.mesh import in_mesh, make_test_mesh
from repro_torch.models.model import Model
from repro_torch.parallel import collectives as col
from repro_torch.parallel.compression import compressed_psum
from repro_torch.parallel.pipeline import pipelined_apply
from repro_torch.train import AdamW, make_train_step
from repro_torch.tree import flatten, map_tree


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


def _mesh(shape, names):
    """A mesh over the group's first ranks; None on a rank outside it."""
    mesh = make_test_mesh(shape, names, device="cpu")
    return mesh if in_mesh(mesh) else None


def _model_inputs(np_params, np_batch):
    model = Model(get_config("smollm-135m").reduced(), device="cpu")
    params = model.params_from_reference(np_params)
    batch = {k: torch.from_numpy(np.array(v)) for k, v in np_batch.items()}
    return model, params, batch


def _found(mesh, params, metrics):
    """Rank 0's result, after checking that every rank of the mesh holds
    the same parameters (they are replicated)."""
    leaves = [p.numpy() for p in flatten(params)[0]]
    col.check_replicated(mesh, *leaves, what="parameters")
    return {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
            "tokens": float(metrics["tokens"]), "params": leaves}


def dp_step(rank, world, shape, names, np_params, np_batch):
    """One data-parallel train step of reduced smollm-135m on ``shape``
    (the batch split over its "pod" and "data" axes), beside the port's
    single-device step on the same inputs."""
    mesh = _mesh(shape, names)
    if mesh is None:
        return None
    model, params, batch = _model_inputs(np_params, np_batch)
    opt = AdamW(lr=1e-3, warmup_steps=2, total_steps=10)
    p2, _, met = make_train_step(model, opt, mesh=mesh)(params, opt.init(params), batch)
    p1, _, met1 = make_train_step(model, opt)(params, opt.init(params), batch)
    return {"mesh": _found(mesh, p2, met), "single": _found(mesh, p1, met1)}


def dp_moe(rank, world, capacity_factor, np_batch):
    """One data-parallel train step of a reduced granite-moe-1b-a400m
    (seeded weights, ``capacity_factor`` large enough that no expert drops
    a token on a shard or on one device) on ("data",) = (2,), beside the
    port's single-device step: the losses, ``ce`` and ``aux``."""
    mesh = _mesh((2,), ("data",))
    if mesh is None:
        return None
    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m").reduced(),
                              capacity_factor=capacity_factor)
    model = Model(cfg, device="cpu")
    params = model.init(seed=5)
    batch = {k: torch.from_numpy(np.array(v)) for k, v in np_batch.items()}
    opt = AdamW(lr=1e-3, warmup_steps=2, total_steps=10)
    out = {}
    for name, step in (("mesh", make_train_step(model, opt, mesh=mesh)),
                       ("single", make_train_step(model, opt))):
        p, _, met = step(params, opt.init(params), batch)
        out[name] = dict(_found(mesh, p, met), ce=float(met["ce"]), aux=float(met["aux"]))
    return out


def step_compressed(rank, world, np_params, np_batch):
    """One ``compress_pod_grads`` step on 2 "pod" ranks (each pod's
    gradients through ``compressed_psum``), beside the single-device step."""
    mesh = _mesh((2,), ("pod",))
    if mesh is None:
        return None
    model, params, batch = _model_inputs(np_params, np_batch)
    opt = AdamW(lr=1e-3, warmup_steps=2, total_steps=10)
    err = map_tree(lambda p: torch.zeros(p.shape, dtype=torch.float32), params)
    step = make_train_step(model, opt, compress_pod_grads=True, mesh=mesh)
    p2, _, met, err2 = step(params, opt.init(params), batch, err)
    p1, _, met1 = make_train_step(model, opt)(params, opt.init(params), batch)
    out = {"mesh": _found(mesh, p2, met), "single": _found(mesh, p1, met1)}
    out["err_max"] = max(float(e.abs().max()) for e in flatten(err2)[0])
    return out


def compress(rank, world, g_np):
    """``compressed_psum`` over 2 "pod" ranks: a replicated input, then
    rank r holding g·(1 + r), then a second step feeding the residual back."""
    mesh = _mesh((2,), ("pod",))
    if mesh is None:
        return None
    g = torch.from_numpy(g_np)
    zeros = torch.zeros_like(g)
    mean, err = compressed_psum(g, mesh, "pod", zeros)
    g_r = g * (1 + rank)
    mean_r, err_r = compressed_psum(g_r, mesh, "pod", zeros)
    mean_r2, err_r2 = compressed_psum(g_r, mesh, "pod", err_r)
    return {k: v.numpy() for k, v in dict(mean=mean, err=err, mean_r=mean_r, err_r=err_r,
                                          mean_r2=mean_r2, err_r2=err_r2).items()}


def _tanh_stack(sp, x):
    for w in sp:
        x = torch.tanh(x @ w)
    return x


def pipeline(rank, world, ws_np, x_np, n_micro):
    """``pipelined_apply`` on 2 "pod" ranks: stage 0 holds Ws[:2], stage 1
    Ws[2:]; both ranks return the whole output."""
    mesh = _mesh((2,), ("pod",))
    if mesh is None:
        return None
    ws = torch.from_numpy(ws_np)
    L, D = ws.shape[0], ws.shape[1]
    out = pipelined_apply(_tanh_stack, ws.reshape(2, L // 2, D, D), torch.from_numpy(x_np),
                          mesh=mesh, n_micro=n_micro)
    col.check_replicated(mesh, out.numpy(), what="pipeline output")
    return out.numpy()
