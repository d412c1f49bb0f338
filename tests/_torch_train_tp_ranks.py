"""Rank bodies of ``tests/test_torch_train_tp.py``. ``run_cases`` runs in
every process of one gloo group of 8 that ``repro_torch.launch.mesh.run_ranks``
spawns, and runs the cases in turn: each builds its mesh over the group's
first ranks (a rank outside it skips the case), imports torch and the port
only, and returns what it found; rank 0 saves it for the test process to
compare with the JAX package, and a case that raises is saved as its
traceback, so that only its own test fails. Every rank of a mesh runs the
same body, as every rank of a split trainer runs the same step."""
import contextlib
import dataclasses
import os
import pickle
import traceback

import numpy as np
import torch

from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.launch.mesh import in_mesh, make_test_mesh
from repro_torch.models import moe as moe_mod
from repro_torch.models.model import Model
from repro_torch.parallel import collectives as col
from repro_torch.train import AdamW, Trainer, TrainerConfig, make_train_step
from repro_torch.tree import flatten, map_tree

AXES = ("data", "model")
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)


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


def _mesh(shape, ranks=None, axes=AXES):
    """A mesh (("data", "model") by default) over ``ranks`` (the group's
    first ones by default); None on a rank outside it. Every rank of the
    group calls it."""
    mesh = make_test_mesh(shape, axes, device="cpu", ranks=ranks)
    return mesh if in_mesh(mesh) else None


def _cfg(arch, over):
    return dataclasses.replace(get_config(arch).reduced(), **over)


def _tensors(np_tree):
    if isinstance(np_tree, dict):
        return {k: _tensors(v) for k, v in np_tree.items()}
    return torch.from_numpy(np.array(np_tree))


def _np(tree):
    return [t.detach().numpy().copy() for t in flatten(tree)[0]]


class _ShardedAux:
    """The single-device MoE with the split step's semantics: the B·S
    tokens in ``n`` contiguous shards (the ("data", "model") split's token
    order), each routed with its own capacity, the aux loss the shards'
    mean (the JAX package's ``pmean`` over the token axes). Patches
    ``moe._moe_reference``, the single-device path of ``moe_block``."""

    def __init__(self, n):
        self.n, self.saved = n, None

    def _ref(self, x2d, params, cfg):
        ys, auxs = [], []
        for c in x2d.chunk(self.n):
            y, probs, idx = moe_mod._moe_local(c, params, cfg)
            ys.append(y)
            auxs.append(moe_mod.switch_aux(probs, idx))
        return torch.cat(ys), torch.stack(auxs).mean()

    def __enter__(self):
        self.saved = moe_mod._moe_reference
        moe_mod._moe_reference = self._ref

    def __exit__(self, *exc):
        moe_mod._moe_reference = self.saved


def _run(model, params, batch, accum, **kw):
    """(gradients' (loss, metrics, grads), the step's (params, opt_state,
    metrics)) of ``make_train_step`` on ``params``."""
    opt = AdamW(**OPT)
    step = make_train_step(model, opt, accum_steps=accum, **kw)
    grads = step.gradients(params, batch)
    return grads, step(params, opt.init(params), batch)


def split_step(rank, world, arch, over, shape, accum, np_params, np_batch):
    """One split train step of reduced ``arch`` (``over`` replaced) on a
    ("data", "model") mesh of ``shape``, beside the port's single-device
    step on the same parameters and batch (a MoE's with ``_ShardedAux``,
    and its plain ``ce``): losses, ``grad_norm``, the gradients and the
    stepped parameters gathered, the stored shards' shapes, and the
    all-gather calls of the step (plain against ZeRO-2 where ``zero2``)."""
    mesh = _mesh(shape)
    if mesh is None:
        return None
    cfg = _cfg(arch, over)
    single = Model(cfg, device="cpu")
    params = single.params_from_reference(np_params)
    batch = _tensors(np_batch)
    split = Model(cfg, device="cpu", mesh=mesh)
    shards = split.shard_params(params)
    found = {"split": {k: v for k, v in vars(split.train_split).items()
                       if k in ("attn", "mlp", "moe", "ssm", "vocab")}}
    runs = {"mesh": (split, shards, {})}
    if cfg.zero2:
        runs["zero2"] = (split, shards, {"zero2_axes": split.param_axes()})
    for name, (model, p, kw) in runs.items():
        col.reset_stats()
        (loss, metrics, grads), (p2, o2, met) = _run(model, p, batch, accum, **kw)
        gathers = col.STATS["ops"].get("all_gather", {}).get("calls", 0)
        found[name] = {
            "loss": float(met["loss"]), "grad_norm": float(met["grad_norm"]),
            "ce": float(met["ce"]), "grad_loss": float(loss), "all_gathers": gathers,
            "grads": _np(model.gather_params(grads)), "params": _np(model.gather_params(p2)),
            "stored": {"params": [tuple(t.shape) for t in flatten(p2)[0]],
                       "mu": [tuple(t.shape) for t in flatten(o2.mu)[0]],
                       "nu": [tuple(t.shape) for t in flatten(o2.nu)[0]]},
        }
    moe = cfg.family == "moe"
    if moe:
        (_, plain, _), _ = _run(single, params, batch, accum)
        found["ce_plain"] = float(plain["ce"])
    with _ShardedAux(shape[0] * shape[1]) if moe else contextlib.nullcontext():
        (loss, _, grads), (p1, _, met) = _run(single, params, batch, accum)
    found["single"] = {"loss": float(met["loss"]), "grad_norm": float(met["grad_norm"]),
                       "ce": float(met["ce"]), "grad_loss": float(loss), "grads": _np(grads),
                       "params": _np(p1)}
    return found


def split_compressed(rank, world, arch, over, np_params, np_batch):
    """A split step on ("pod", "data", "model") = (2, 2, 2) with the pod
    axis's gradient reduction in int8 (``compress_pod_grads``), beside the
    exact split step on the same mesh: losses, the stepped parameters
    gathered, and the largest residual."""
    mesh = _mesh((2, 2, 2), axes=("pod", "data", "model"))
    if mesh is None:
        return None
    cfg = _cfg(arch, over)
    model = Model(cfg, device="cpu", mesh=mesh)
    shards = model.shard_params(Model(cfg, device="cpu").params_from_reference(np_params))
    batch = _tensors(np_batch)
    opt = AdamW(**OPT)
    err = map_tree(lambda t: torch.zeros(t.shape, dtype=torch.float32), shards)
    step = make_train_step(model, opt, compress_pod_grads=True)
    p2, _, met, err2 = step(shards, opt.init(shards), batch, err)
    p1, _, met1 = make_train_step(model, opt)(shards, opt.init(shards), batch)
    return {"loss": float(met["loss"]), "loss_exact": float(met1["loss"]),
            "params": _np(model.gather_params(p2)), "params_exact": _np(model.gather_params(p1)),
            "err_max": max(float(e.abs().max()) for e in flatten(err2)[0]),
            "err_shapes": [tuple(e.shape) for e in flatten(err2)[0]],
            "shapes": [tuple(t.shape) for t in flatten(shards)[0]]}


def collectives_grads(rank, world):
    """Each collective with a gradient on a ("data", "model") = (2, 4) mesh
    against what it should give: y = Σ_r f(x·(r+1)) over "model" for each
    op, differentiated by autograd on every rank."""
    mesh = _mesh((2, 4))
    if mesh is None:
        return None
    r = col.axis_index(mesh, "model")
    x = torch.arange(8, dtype=torch.float32).requires_grad_()
    out = {}
    # enter: identity forward; backward the ranks' gradients summed
    y = col.enter(x, mesh, "model") * (r + 1)
    (g,) = torch.autograd.grad(y.sum(), x)
    out["enter"] = (y.detach().numpy(), g.numpy())
    # leave: the ranks' values summed forward; identity backward
    y = col.leave(x * (r + 1), mesh, "model")
    (g,) = torch.autograd.grad((y * y).sum(), x)
    out["leave"] = (y.detach().numpy(), g.numpy())
    # psum: summed both ways
    y = col.psum(x * (r + 1), mesh, "model")
    (g,) = torch.autograd.grad((y * (r + 1)).sum(), x)
    out["psum"] = (y.detach().numpy(), g.numpy())
    # gather, replicated consumer: the slice of the (equal) gradient
    y = col.gather(x[2 * r:2 * r + 2] * (r + 1), mesh, "model", backward="slice")
    (g,) = torch.autograd.grad((y * torch.arange(8.0)).sum(), x)
    out["gather_slice"] = (y.detach().numpy(), g.numpy())
    # gather, split consumer: the ranks' gradients reduce-scattered
    y = col.gather(x[2 * r:2 * r + 2], mesh, "model", backward="reduce_scatter")
    (g,) = torch.autograd.grad((y * (r + 1)).sum(), x)
    out["gather_rs"] = (y.detach().numpy(), g.numpy())
    # all-to-all there and back: chunk j to rank j; its gradient returns
    y = col.all_to_all_grad(x.reshape(4, 2) * (r + 1), mesh, "model")
    (g,) = torch.autograd.grad((y * (10 * r + torch.arange(4.0))[:, None]).sum(), x)
    out["all_to_all"] = (y.detach().numpy(), g.numpy())
    col.reset_stats()
    col.reduce_scatter(torch.ones(8), mesh, "model")
    out["stats"] = {k: dict(v) for k, v in col.STATS["ops"].items()}
    return out


def checkpoint_elastic(rank, world, arch, over, np_params, np_batch, ckpt_dir):
    """One split step on (2, 4), saved whole; restored onto a (1, 2) mesh
    over ranks 0-1 and onto one device (rank 0): the restored shards
    gathered, and the whole leaves."""
    cfg = _cfg(arch, over)
    mesh = _mesh((2, 4))
    sub = _mesh((1, 2), ranks=(0, 1))
    found = {}
    if mesh is not None:
        model = Model(cfg, device="cpu", mesh=mesh)
        params = model.shard_params(Model(cfg, device="cpu").params_from_reference(np_params))
        opt = AdamW(**OPT)
        p, o, _ = make_train_step(model, opt)(params, opt.init(params), _tensors(np_batch))
        ckpt = CheckpointManager(ckpt_dir)
        specs = model.train_split.storage
        ckpt.save(1, {"params": p, "mu": o.mu}, mesh=mesh,
                  specs={"params": specs, "mu": specs}, blocking=True)
        found["saved"] = _np(model.gather_params(p))
        found["saved_mu"] = _np(model.gather_params(o.mu))
        found["stored"] = [tuple(t.shape) for t in flatten(p)[0]]
    if sub is not None:
        model = Model(cfg, device="cpu", mesh=sub)
        like = model.shard_params(model.init(seed=9))
        specs = model.train_split.storage
        ckpt = CheckpointManager(ckpt_dir)
        got, meta = ckpt.restore({"params": like, "mu": like}, mesh=sub,
                                 specs={"params": specs, "mu": specs})
        found["sub_stored"] = [tuple(t.shape) for t in flatten(got["params"])[0]]
        found["sub"] = _np(model.gather_params(got["params"]))
        found["sub_mu"] = _np(model.gather_params(got["mu"]))
        found["sub_step"] = meta["step"]
    if rank == 0:
        one = Model(cfg, device="cpu")
        like = one.init(seed=9)
        got, _ = CheckpointManager(ckpt_dir).restore({"params": like, "mu": like})
        found["one"] = _np(got["params"])
        found["one_mu"] = _np(got["mu"])
    return found


def trainer_resume(rank, world, arch, over, shape, ckpt_root):
    """A split ``Trainer`` on ``shape``: two steps straight, and two steps
    with a failure at step 1 and a resume from the checkpoint of step 1;
    the final parameters gathered, and the events."""
    mesh = _mesh(shape)
    if mesh is None:
        return None
    from repro_torch.data import SyntheticLMData

    cfg = _cfg(arch, over)
    out = {}
    for name, fail in (("straight", None), ("resumed", 1)):
        model = Model(cfg, device="cpu", mesh=mesh)
        data = SyntheticLMData(cfg, batch=4, seq=32, seed=2, device="cpu")
        tcfg = TrainerConfig(total_steps=2, ckpt_every=1, ckpt_dir=os.path.join(ckpt_root, name),
                             log_every=100)
        trainer = Trainer(model, AdamW(**OPT), data, tcfg, fail_at_step=fail,
                          log_fn=lambda _: None)
        try:
            state, met = trainer.run()
        except RuntimeError:
            state, met = trainer.run()
        out[name] = {"params": _np(model.gather_params(state.params)),
                     "mu": _np(model.gather_params(state.opt_state.mu)),
                     "step": state.step, "events": list(trainer.events),
                     "loss": float(met["loss"]),
                     "stored": [tuple(t.shape) for t in flatten(state.params)[0]]}
    return out
