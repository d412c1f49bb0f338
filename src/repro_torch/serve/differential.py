"""Serve-level differential comparators.

Port of the JAX package's ``serve/differential.py``. Two contracts, two
lanes:

* **Bitwise** — head-only ("model") meshes move parallel work between
  ranks without changing any reduction order inside the attention, so
  their token streams must equal the single-device paged path's.
  ``assert_streams_equal`` is that lane.

* **Tolerance** — kv-sequence-split ("seq", and 2D ("model", "seq"))
  meshes recombine each row's softmax from per-rank flash partials
  through ``distributed_softmax``; the combine is exact in real
  arithmetic but associates the float reductions differently, so logits
  agree only to rounding. The contract is argmax token identity (greedy
  streams are argmax decisions) plus a max-abs-logit bound:
  ``assert_streams_equal`` on the tokens, ``assert_logits_close`` on the
  one-step logit gap and NaN-freedom (the empty-shard guard's hot-path
  obligation).

Streams are matched by admission order, not rid: rids are globally
auto-assigned, so two ``serve()`` calls over equal workloads hand out
different ids for corresponding requests. Inputs may be numpy arrays or
tensors (``np.asarray`` takes CPU tensors).
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "match_streams",
    "assert_streams_equal",
    "assert_logits_close",
]


def match_streams(base: dict, other: dict):
    """Pair two ``serve()`` result dicts (rid → token array) by
    admission order. Returns a list of ``(tokens_base, tokens_other)``
    numpy pairs; raises if the workloads differ in size."""
    if len(base) != len(other):
        raise AssertionError(
            f"stream count mismatch: {len(base)} vs {len(other)}"
        )
    pairs = []
    for (_, va), (_, vb) in zip(sorted(base.items()), sorted(other.items())):
        pairs.append((np.asarray(va), np.asarray(vb)))
    return pairs


def assert_streams_equal(base: dict, other: dict, *, label: str = ""):
    """Every matched stream's tokens are identical. This is the full
    contract for head-only meshes (bitwise lane) and the token half of
    the tolerance lane: greedy tokens are argmax decisions, so argmax
    token identity *is* stream equality."""
    for i, (va, vb) in enumerate(match_streams(base, other)):
        np.testing.assert_array_equal(
            va, vb, err_msg=f"{label} stream #{i} (admission order) diverged"
        )


def assert_logits_close(base, other, *, atol: float, label: str = ""):
    """One-step logit comparator for the tolerance lane: ``other`` must
    be NaN-free (the empty-shard guard's obligation once the combine is
    on the hot path), agree with ``base`` on every row's argmax, and
    stay within ``atol`` max-abs difference."""
    a = np.asarray(base, np.float64)
    b = np.asarray(other, np.float64)
    if a.shape != b.shape:
        raise AssertionError(f"{label} logits shape {a.shape} vs {b.shape}")
    if np.isnan(b).any():
        raise AssertionError(f"{label} sharded logits contain NaN")
    am_a, am_b = a.argmax(-1), b.argmax(-1)
    if not (am_a == am_b).all():
        bad = int((am_a != am_b).sum())
        raise AssertionError(
            f"{label} argmax disagrees on {bad}/{am_a.size} rows"
        )
    gap = float(np.abs(a - b).max())
    if gap > atol:
        raise AssertionError(f"{label} max|Δlogit| {gap:.3e} > atol {atol:.1e}")
    return gap
