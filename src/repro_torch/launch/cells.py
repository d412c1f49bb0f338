"""Dry-run cell construction: (arch × shape × mesh) → one rank's step.

Port of the JAX package's ``launch/cells.py``. ``build_cell`` returns
everything ``dryrun.py`` needs to count one rank's share of a cell:

  fn            — the step (train / prefill / decode) of a model split over
                  the mesh (``Model(cfg, mesh=mesh)``)
  args          — this rank's shards of every input, as meta tensors
                  (nothing allocated: the JAX package's ShapeDtypeStructs,
                  sharded)
  specs         — each argument leaf's ``rules.spec``: the JAX package's
                  ``in_shardings``
  donate        — the arguments the step updates in place (its
                  ``donate_argnums``)
  model_flops   — 6·N·D (train) / 2·N·tokens (prefill) / 2·N·B (decode)
                  for the usefulness ratio

The mesh is a ``DeviceMesh`` whose process group holds its ranks: under
``launch.mesh.fake_ranks`` one process poses as one of them, and the step's
collectives return at once.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.configs.base import cell_is_runnable, get_config, get_shape
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.models.model import Model
from repro_torch.parallel.sharding import map_dicts, shard_leaf, tree_specs
from repro_torch.train.optimizer import AdamW, OptState
from repro_torch.train.train_step import make_train_step


@dataclass
class Cell:
    arch: str
    shape: str
    fn: Any
    args: tuple
    specs: tuple
    donate: tuple
    model_flops: float
    rules_fallbacks: list
    runnable: bool = True
    skip_reason: str = ""


def _config(arch, overrides):
    cfg = get_config(arch)
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def input_specs(arch: str, shape_name: str, mesh, overrides: dict | None = None) -> dict:
    """Every model input of this cell as a whole (global) meta tensor."""
    cfg = _config(arch, overrides)
    shape = get_shape(shape_name)
    if shape.kind in ("train", "prefill"):
        return SyntheticLMData(cfg, batch=shape.global_batch, seq=shape.seq_len,
                               device="cpu").batch_specs()
    model = Model(cfg, device="meta", mesh=mesh)
    return {
        "tokens": torch.empty((shape.global_batch, 1), dtype=torch.int32, device="meta"),
        "cache": model.init_cache(shape.global_batch, shape.seq_len),
    }


def _shards(tree, axes, rules, mesh):
    """(this rank's shard of each leaf, each leaf's spec)."""
    specs = tree_specs(tree, axes, rules)
    return map_dicts(lambda t, sp: shard_leaf(t, sp, mesh), tree, specs), specs


def build_cell(arch: str, shape_name: str, mesh, overrides: dict | None = None,
               device="meta") -> Cell:
    """The cell (module docstring). ``device``: where the step's model runs;
    its arguments stay meta stand-ins, so a caller that runs the step on
    real tensors passes their device and makes tensors of the same shapes
    and dtypes."""
    cfg = _config(arch, overrides)
    shape = get_shape(shape_name)
    ok, why = cell_is_runnable(cfg, shape)
    if not ok:
        return Cell(arch, shape_name, None, (), (), (), 0.0, [], False, why)

    model = Model(cfg, device=device, mesh=mesh)
    rules = model.rules
    pshapes, paxes = model.abstract_params()
    params, pspecs = _shards(pshapes, paxes, rules, mesh)
    n_active = cfg.active_param_count()

    if shape.kind == "train":
        opt = AdamW(total_steps=10_000)
        ostate = opt.init(params)
        ospecs = OptState(step=(), mu=pspecs, nu=pspecs)
        # gradient accumulation bounds the live activation tokens a rank
        # (the per-arch train_accum)
        accum = max(1, cfg.train_accum)
        micro = shape.global_batch // accum
        data = SyntheticLMData(cfg, batch=micro, seq=shape.seq_len, device="cpu")
        whole, axes = data.batch_specs(), data.batch_axes()
        if accum > 1:
            whole = {k: torch.empty((accum,) + tuple(v.shape), dtype=v.dtype, device="meta")
                     for k, v in whole.items()}
            axes = {k: (None,) + ax for k, ax in axes.items()}
        batch, bspecs = _shards(whole, axes, rules, mesh)
        use_zero2 = bool(cfg.zero2) and cfg.param_sharding == "fsdp"
        fn = make_train_step(model, opt, accum_steps=accum, local_batch=True,
                             zero2_axes=paxes if use_zero2 else None)
        args = (params, ostate, batch)
        specs = (pspecs, ospecs, bspecs)
        donate = (0, 1)
        model_flops = 6.0 * n_active * shape.tokens
    elif shape.kind == "prefill":
        data = SyntheticLMData(cfg, batch=shape.global_batch, seq=shape.seq_len, device="cpu")
        whole = data.batch_specs()
        B, S = shape.global_batch, shape.seq_len
        tokens, tspec = _shards(whole["tokens"], ("batch", "seq"), rules, mesh)
        if cfg.family == "vlm":
            pe, pespec = _shards(whole["patch_embeds"], ("batch", None, None), rules, mesh)

            def fn(params, tokens, patch_embeds):
                return model.prefill(params, tokens, S, patch_embeds=patch_embeds, batch_size=B)

            args, specs = (params, tokens, pe), (pspecs, tspec, pespec)
        else:

            def fn(params, tokens):
                return model.prefill(params, tokens, S, batch_size=B)

            args, specs = (params, tokens), (pspecs, tspec)
        donate = ()
        model_flops = 2.0 * n_active * shape.tokens
    else:  # decode
        whole = input_specs(arch, shape_name, mesh, overrides)
        cache, cspecs = _shards(whole["cache"], model.cache_axes(whole["cache"]), rules, mesh)
        tok, tspec = _shards(whole["tokens"], ("batch", None), rules, mesh)
        fn = model.decode_step
        args = (params, cache, tok)
        specs = (pspecs, cspecs, tspec)
        donate = (1,)
        model_flops = 2.0 * n_active * shape.global_batch

    return Cell(arch, shape_name, fn, args, specs, donate, model_flops, rules.fallbacks)
