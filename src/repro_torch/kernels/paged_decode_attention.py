"""Block-paged flash decode/verify attention (kernel 1 of the port).

Replaces the JAX package's Pallas TPU kernel
``kernels/paged_decode_attention.py::paged_decode_attention`` for T ≥ 1
queries over float32 or bfloat16 pools, and its int8 mode: int8 pools
with per-vector bfloat16 scales ``[NB,BS,KV]``, dequantized in the kernel
as ``int8 · scale / 127``, and its partials mode for the kv-sequence
split: ``owned`` [B,MB] marks the table entries whose blocks this rank
holds (the others are skipped), and ``partials=True`` returns the
unnormalised float32 triple ``(m, l, acc)`` for a cross-rank softmax
combine. The CUDA source is ``csrc/paged_decode_attention.cu`` (its header
says what bounds it on the H100 and what the design does about it).

``paged_decode_attention`` checks its arguments, then dispatches on the
tensors' device: CPU tensors take the plain PyTorch version
(``plain_paged_decode_attention``, the dense-gather oracles), CUDA tensors
the kernel — or it raises. Its ``launches`` attribute counts kernel
launches over float pools, ``launches_int8`` those over int8 pools and
``launches_partials`` those in the partials mode (over either pool).
``paged_plan`` says how the kernel launches: the tiles a row's table is
cut into, how many blocks (one cluster) share them, the ring's depth, and
whether the tiles arrive by 16-byte ``cp.async``. ``paged_attention_op``
is the same function (decode/verify, float or int8 pools) as the
``torch.library`` operator ``repro_torch::paged_decode_attention``, with
a vmap rule, so a decode plan's ``relic_pfor`` over requests launches the
kernel once a chunk; ``paged_partials_op`` is the partials mode as the
operator ``repro_torch::paged_decode_partials``. The models call
``paged_decode_call`` and ``paged_partials_call``, which take the
operator only on meta tensors or where a transform or a dispatch mode
would see the call (``_build.through_operator``), and the wrapper
directly otherwise.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import (DECODE_THREADS, _cdiv, decode_layout,
                                                  decode_ring)
from repro_torch.kernels.ref import paged_attention_ref, paged_partials_ref

_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_INT8 = 2  # the C entry point's code for int8 pools
# csrc/paged_decode_attention.cu: the dense decode kernel's block (128
# threads, the same shared-memory layout and ring of 64-, 32- or 16-key
# tiles), a cluster of at most 8 splits dealt a row's tiles round-robin
PAGED_MAX_SPLITS, PAGED_TILES_PER_SPLIT = 8, 8
TABLE_IDS = 256  # table entries of a split's tiles the kernel keeps in shared memory


def paged_plan(q_dtype, kv_dtype, B: int, T: int, H: int, KV: int, hd: int, BS: int, MB: int,
               aligned: bool = True, plan_kv: Optional[int] = None) -> dict:
    """How ``csrc/paged_decode_attention.cu`` runs T queries of ``q_dtype``
    over [NB,BS,KV,hd] pools of ``kv_dtype`` and [B,MB] tables: a row's
    table is cut into ``n_tiles`` tiles of at most ``tile`` keys —
    ``entries_per_tile`` table entries each where BS ≤ tile, or
    ``slices_per_entry`` slices of one entry where BS > tile — and tile i
    goes to split i mod ``splits``. One block per (row, kv head, group of
    ``rows`` of its T·g query rows, split), the grid (B, KV · groups,
    splits), the splits one cluster. The splits, the tile and the ring
    depend on the pool's shape and the card, never on T or the lengths,
    so that verify equals decode bitwise: splits double (up to 8, at most
    one per tile) until B · KV · splits reaches ``_build.TARGET_BLOCKS``
    and no split holds more than ``PAGED_TILES_PER_SPLIT`` tiles of a
    full row; the ring (``stages`` tiles, rows padded by 16 bytes) is
    sized for the widest block (8 rows, 4 over int8 pools). The tiles
    arrive by 16-byte ``cp.async`` (path "cp.async") where a head's row
    is a multiple of 16 bytes and the pools are ``aligned``, else by
    element loads ("direct"). ``plan_kv``: the kv heads the splits are
    counted for, where a rank of a head split launches over KV of them
    (its local heads): the splits then equal the unsharded launch's, and
    each query's reduction order with them."""
    if q_dtype not in _Q_DTYPES:
        raise TypeError(f"paged_decode_attention: no kernel for q of {q_dtype}")
    int8 = kv_dtype == torch.int8
    kv_es = 1 if int8 else (4 if kv_dtype == torch.float32 else 2)
    max_rows = 4 if int8 else 8
    tile, stages = decode_ring(hd, kv_es, max_rows, "paged_decode_attention", 4 * TABLE_IDS)
    nrows = T * (H // KV)
    rows = 1 if nrows == 1 else 4 if nrows <= 4 else max_rows
    groups = _cdiv(nrows, rows)
    if BS <= tile:
        epr, spe = tile // BS, 1
        n_tiles = _cdiv(MB, epr)
    else:
        epr, spe = 1, _cdiv(BS, tile)
        n_tiles = MB * spe
    pairs = max(1, B * (KV if plan_kv is None else plan_kv))
    splits = 1
    while splits < min(PAGED_MAX_SPLITS, n_tiles) and (
            splits * pairs < _build.TARGET_BLOCKS or _cdiv(n_tiles, splits) > PAGED_TILES_PER_SPLIT):
        splits *= 2
    return {"path": "cp.async" if aligned and hd * kv_es % 16 == 0 else "direct",
            "rows": rows, "splits": splits, "tile": tile, "stages": stages,
            "entries_per_tile": epr, "slices_per_entry": spe, "n_tiles": n_tiles,
            "smem": decode_layout(hd, kv_es, rows, stages, tile) + 4 * TABLE_IDS,
            "grid": (B, KV * groups, splits), "cluster": (1, 1, splits),
            "threads": DECODE_THREADS}


def plain_paged_decode_attention(q, k_pool, v_pool, block_tables, lengths, k_scale=None,
                                 v_scale=None, owned=None, partials=False):
    """The kernel's function in plain PyTorch: the dense-gather oracle, or
    with ``owned`` / ``partials`` the partials oracle (normalised as the
    kernel normalises when ``partials`` is False)."""
    if owned is None and not partials:
        return paged_attention_ref(q, k_pool, v_pool, block_tables, lengths, k_scale, v_scale)
    if owned is None:
        owned = torch.ones(block_tables.shape, dtype=torch.int32, device=q.device)
    m, l, acc = paged_partials_ref(
        q, k_pool, v_pool, block_tables, lengths, owned, k_scale, v_scale
    )
    if partials:
        return m, l, acc
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)


def _check(q, k_pool, v_pool, block_tables, lengths, k_scale, v_scale, owned):
    """Raise on anything the kernel does not take; returns the C code of
    the pool type."""
    B, T, H, hd = q.shape
    NB, BS, KV, hd_k = k_pool.shape
    MB = block_tables.shape[1] if block_tables.dim() == 2 else -1
    tensors = [("k_pool", k_pool), ("v_pool", v_pool), ("block_tables", block_tables),
               ("lengths", lengths)]
    if q.dtype not in _Q_DTYPES:
        raise TypeError(f"paged_decode_attention: q must be float32 or bfloat16, got {q.dtype}")
    if k_pool.dtype == torch.int8:
        if k_scale is None or v_scale is None:
            raise ValueError("paged_decode_attention: int8 pools need k_scale and v_scale")
        for name, s in (("k_scale", k_scale), ("v_scale", v_scale)):
            if s.dtype != torch.bfloat16 or s.shape != k_pool.shape[:3]:
                raise ValueError(
                    f"paged_decode_attention: {name} must be bfloat16 of shape "
                    f"{tuple(k_pool.shape[:3])}, got {s.dtype} {tuple(s.shape)}"
                )
        tensors += [("k_scale", k_scale), ("v_scale", v_scale)]
        kv_code = _INT8
    elif k_scale is not None or v_scale is not None:
        raise ValueError(
            f"paged_decode_attention: scales go with int8 pools only, got a {k_pool.dtype} pool"
        )
    elif k_pool.dtype == q.dtype:
        kv_code = _Q_DTYPES[q.dtype]
    else:
        raise TypeError(
            f"paged_decode_attention: a float pool must share q's type, got "
            f"q {q.dtype}, pool {k_pool.dtype}"
        )
    if v_pool.dtype != k_pool.dtype:
        raise TypeError(
            f"paged_decode_attention: k_pool {k_pool.dtype} and v_pool {v_pool.dtype} differ"
        )
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("paged_decode_attention: block_tables and lengths must be int32")
    if owned is not None:
        if owned.dtype != torch.int32 or owned.shape != block_tables.shape:
            raise ValueError(
                f"paged_decode_attention: owned must be int32 of the tables' shape "
                f"{tuple(block_tables.shape)}, got {owned.dtype} {tuple(owned.shape)}"
            )
        tensors.append(("owned", owned))
    if (v_pool.shape != k_pool.shape or hd_k != hd or H % KV
            or block_tables.shape != (B, MB) or lengths.shape != (B,)):
        raise ValueError(
            f"paged_decode_attention: bad shapes q{tuple(q.shape)} pool{tuple(k_pool.shape)} "
            f"v{tuple(v_pool.shape)} tables{tuple(block_tables.shape)} "
            f"lengths{tuple(lengths.shape)}"
        )
    for name, t in tensors:
        if t.device != q.device:
            raise ValueError(f"paged_decode_attention: {name} on {t.device}, q on {q.device}")
    for name, t in [("q", q)] + tensors:
        if not t.is_contiguous():
            raise ValueError(f"paged_decode_attention: {name} must be contiguous")
    return kv_code


def paged_decode_attention(q, k_pool, v_pool, block_tables, lengths, k_scale=None, v_scale=None,
                           *, owned=None, partials: bool = False,
                           plan_kv_heads: Optional[int] = None):
    """q [B,T,H,hd] float32/bfloat16; pools [NB,BS,KV,hd] in q's type, or
    int8 with ``k_scale``/``v_scale`` [NB,BS,KV] bfloat16; ``block_tables``
    [B,MB] int32 block ids (< NB); ``lengths`` [B] int32 committed lengths
    (query t attends positions < lengths + t + 1) → [B,T,H,hd] in q's
    dtype. ``owned`` [B,MB] int32: table entries whose value is 0 are
    skipped. ``partials=True`` returns ``(m, l, acc)`` instead: float32
    [B,T,H], [B,T,H] and [B,T,H,hd], unnormalised, exactly
    (-1e30, 0, 0) for a query that attends no key. ``plan_kv_heads``: the
    unsharded kv head count of a head split's rank, whose launch over its
    local heads then splits each row as the single-device launch does
    (``paged_plan``'s ``plan_kv``), so those heads come out bitwise the
    same."""
    _build.refuse_grad("paged_decode_attention", q, k_pool, v_pool, k_scale, v_scale)
    kv_code = _check(q, k_pool, v_pool, block_tables, lengths, k_scale, v_scale, owned)
    if q.device.type == "cpu":
        return plain_paged_decode_attention(
            q, k_pool, v_pool, block_tables, lengths, k_scale, v_scale, owned, partials
        )
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: no kernel for device {q.device}")
    B, T, H, hd = q.shape
    NB, BS, KV, _ = k_pool.shape
    if partials:
        f32 = dict(dtype=torch.float32, device=q.device)
        m, l = torch.empty((B, T, H), **f32), torch.empty((B, T, H), **f32)
        out = torch.empty((B, T, H, hd), **f32)
    else:
        out = torch.empty_like(q)
    if B == 0 or T == 0:
        return (m, l, out) if partials else out
    int8 = kv_code == _INT8
    plan = paged_plan(q.dtype, k_pool.dtype, B, T, H, KV, hd, BS, block_tables.shape[1],
                      _build.aligned16(k_pool, v_pool), plan_kv_heads)
    err = _build.library().paged_decode_attention(
        _Q_DTYPES[q.dtype], kv_code, q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        k_scale.data_ptr() if int8 else None, v_scale.data_ptr() if int8 else None,
        block_tables.data_ptr(), lengths.data_ptr(),
        None if owned is None else owned.data_ptr(), out.data_ptr(),
        m.data_ptr() if partials else None, l.data_ptr() if partials else None,
        B, T, H, KV, hd, BS, block_tables.shape[1], int(partials), plan["rows"],
        plan["splits"], plan["stages"], plan["tile"], int(plan["path"] == "cp.async"),
        1.0 / math.sqrt(hd),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "paged_decode_attention")
    if partials:
        paged_decode_attention.launches_partials += 1
        return m, l, out
    if int8:
        paged_decode_attention.launches_int8 += 1
    else:
        paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
paged_decode_attention.launches_int8 = 0
paged_decode_attention.launches_partials = 0


# ---------------------------------------------------------------------------
# the kernel as an operator that torch.func.vmap and make_fx see through


@torch.library.custom_op("repro_torch::paged_decode_attention", mutates_args=())
def paged_attention_op(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                       block_tables: torch.Tensor, lengths: torch.Tensor,
                       k_scale: Optional[torch.Tensor] = None,
                       v_scale: Optional[torch.Tensor] = None,
                       plan_kv_heads: Optional[int] = None) -> torch.Tensor:
    """``paged_decode_attention`` (decode/verify, float or int8 pools) as
    the operator ``repro_torch::paged_decode_attention``: on CUDA tensors
    it launches the kernel (and counts the launch), on CPU tensors it runs
    the plain version, as the wrapper does. Under ``torch.func.vmap`` its
    rule (``_paged_vmap``) folds the mapped axis into the rows, so a
    vmapped decode launches the kernel once; under ``make_fx`` it is one
    node. The ctypes launch itself reads ``data_ptr()``, which neither a
    vmapped tensor nor a tracing one has."""
    return paged_decode_attention(q, k_pool, v_pool, block_tables, lengths, k_scale, v_scale,
                                  plan_kv_heads=plan_kv_heads)


@paged_attention_op.register_fake
def _paged_fake(q, k_pool, v_pool, block_tables, lengths, k_scale=None, v_scale=None,
                plan_kv_heads=None):
    return torch.empty_like(q)


def _to_front(x, d, g):
    """``x`` with its mapped axis ``d`` first, broadcast to ``g`` where
    ``d`` is None (an input the map does not vary)."""
    return x.unsqueeze(0).expand((g,) + tuple(x.shape)) if d is None else x.movedim(d, 0)


@paged_attention_op.register_vmap
def _paged_vmap(info, in_dims, q, k_pool, v_pool, block_tables, lengths, k_scale=None,
                v_scale=None, plan_kv_heads=None):
    """The map's g items as g·B rows of one call, as the Pallas kernel's
    batching rule folds them: q and lengths to [g·B, …]; a mapped pool
    (either, or a scale) folds all four to [g·NB, …] and item j's table
    entries move by j·NB, mapped or not; pools the map does not vary stay
    as they are, tables unmoved."""
    g = info.batch_size
    qd, kd, vd, td, ld, ksd, vsd = (tuple(in_dims) + (None,) * 7)[:7]

    def fold(x, d):
        x = _to_front(x, d, g)
        return x.reshape((g * x.shape[1],) + tuple(x.shape[2:])).contiguous()

    pools = [k_pool, v_pool, k_scale, v_scale]
    pool_dims = [kd, vd, ksd, vsd]
    tables = _to_front(block_tables, td, g)
    if any(d is not None for x, d in zip(pools, pool_dims) if x is not None):
        NB = _to_front(k_pool, kd, g).shape[1]
        pools = [None if x is None else fold(x, d) for x, d in zip(pools, pool_dims)]
        shift = torch.arange(g, device=tables.device, dtype=tables.dtype) * NB
        tables = tables + shift.view((g,) + (1,) * (tables.dim() - 1))
    tables = tables.reshape((-1,) + tuple(tables.shape[2:])).contiguous()
    out = torch.ops.repro_torch.paged_decode_attention(
        fold(q, qd), pools[0], pools[1], tables, fold(lengths, ld), pools[2], pools[3],
        plan_kv_heads)
    return out.reshape((g, -1) + tuple(out.shape[1:])), 0


def paged_decode_call(q, k_pool, v_pool, block_tables, lengths, k_scale=None, v_scale=None,
                      plan_kv_heads: Optional[int] = None):
    """The paged kernel as the models call it: through the operator
    (``paged_attention_op``) where ``_build.through_operator`` says so —
    on meta tensors, under a ``torch.func`` transform (a decode plan's
    vmap) or a dispatch mode (``make_fx``, the op counter), since only the
    operator carries the call there — and straight to the wrapper
    otherwise, which spares every eager decode the dispatcher's host time
    (chip_smoke.py prints both per call). ``plan_kv_heads``: a head split's
    rank (``paged_decode_attention``)."""
    if _build.through_operator(q):
        return paged_attention_op(q, k_pool, v_pool, block_tables, lengths, k_scale, v_scale,
                                  plan_kv_heads)
    return paged_decode_attention(q, k_pool, v_pool, block_tables, lengths, k_scale, v_scale,
                                  plan_kv_heads=plan_kv_heads)


@torch.library.custom_op("repro_torch::paged_decode_partials", mutates_args=())
def paged_partials_op(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                      block_tables: torch.Tensor, lengths: torch.Tensor, owned: torch.Tensor,
                      k_scale: Optional[torch.Tensor] = None,
                      v_scale: Optional[torch.Tensor] = None,
                      plan_kv_heads: Optional[int] = None
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The partials mode (``partials=True``) as the operator
    ``repro_torch::paged_decode_partials``: float32 ``(m, l, acc)``."""
    return paged_decode_attention(q, k_pool, v_pool, block_tables, lengths, k_scale, v_scale,
                                  owned=owned, partials=True, plan_kv_heads=plan_kv_heads)


@paged_partials_op.register_fake
def _partials_fake(q, k_pool, v_pool, block_tables, lengths, owned, k_scale=None, v_scale=None,
                   plan_kv_heads=None):
    B, T, H, hd = q.shape
    return (q.new_empty((B, T, H), dtype=torch.float32),
            q.new_empty((B, T, H), dtype=torch.float32),
            q.new_empty((B, T, H, hd), dtype=torch.float32))


paged_partials_op.register_vmap(_build.loop_vmap(paged_partials_op))


def paged_partials_call(q, k_pool, v_pool, block_tables, lengths, owned, k_scale=None,
                        v_scale=None, plan_kv_heads: Optional[int] = None):
    """The partials mode through its operator where
    ``_build.through_operator`` says so, straight to the wrapper
    otherwise."""
    if _build.through_operator(q):
        return paged_partials_op(q, k_pool, v_pool, block_tables, lengths, owned, k_scale,
                                 v_scale, plan_kv_heads)
    return paged_decode_attention(q, k_pool, v_pool, block_tables, lengths, k_scale, v_scale,
                                  owned=owned, partials=True, plan_kv_heads=plan_kv_heads)
