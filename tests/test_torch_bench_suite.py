"""The port's benchmark suite (``repro_torch.bench_suite``) against the
JAX package's on the CPU: each ``build`` makes the same arrays from the
same seed; each of the ten benchmarks' restructured value (the port's
``parallel_value``, through the plan layer at the adviser's granularity)
equals the JAX ``serial_value``; the port's own ``serial_value`` agrees
too (on the first 64 items: its Python loop runs one item after another,
slow at 8192 GeoIP lookups or 2048 BVH descents); the Figs. 1–2 sweep
kernels (pfl, cc) restructure to the JAX per-item results; and the
Figs. 3–4 runner gives ``BENCH_aira.json``'s geomeans.

Tolerances: integer and boolean results exactly; float32 results within
1e-5 relative and absolute (the same float32 operations, with sums,
``exp``, ``sqrt`` and ``sin`` from two libraries, a few ulps apart).
"""
import json
import os

import jax
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro.bench_suite import BENCHMARKS as J_BENCH
from repro.bench_suite import cc as j_cc
from repro.bench_suite import pfl as j_pfl
from repro_torch.bench_suite import BENCHMARKS as T_BENCH
from repro_torch.bench_suite import cc as t_cc
from repro_torch.bench_suite import fig34
from repro_torch.bench_suite import pfl as t_pfl
from repro_torch.core import relic_pfor
from repro_torch.core.plan import clear_plan_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden_aira_decisions.json")
NAMES = list(J_BENCH)
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def data():
    """name → (JAX data, port data on the CPU), from the same seed."""
    return {n: (J_BENCH[n].build(), T_BENCH[n].build(device="cpu")) for n in NAMES}


def _assert_same(got, want, label):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape, label
    if np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(got, want, err_msg=label, **TOL)
    else:
        np.testing.assert_array_equal(got, want, err_msg=label)


def test_registry_matches_jax():
    assert list(T_BENCH) == NAMES
    for n in NAMES:
        j, t = J_BENCH[n], T_BENCH[n]
        assert (t.combine, t.force, t.realized_granularity, t.locality_penalty) == (
            j.combine, j.force, j.realized_granularity, j.locality_penalty), n
        assert (t.trace is None) == (j.trace is None), n


@pytest.mark.parametrize("name", NAMES)
def test_build_makes_the_jax_arrays(data, name):
    """Every array of the port's data equals the JAX build's, key by key
    (the JAX package's 32-bit types: int64 and float64 numpy arrays land
    as int32 and float32 on both sides)."""
    jd, td = data[name]
    jd = {k: v for k, v in jd.items() if k != "_np"}
    td = {k: v for k, v in td.items() if k != "_np"}
    j_leaves = jax.tree_util.tree_flatten_with_path(jd)[0]
    t_map = {}
    for path, leaf in pytree.tree_flatten_with_path(td)[0]:
        t_map[tuple(str(getattr(p, "key", p)) for p in path)] = leaf
    if name == "VWAP":  # the port keeps the message slots beside the messages
        assert torch.equal(t_map.pop(("slots",)), torch.arange(30, dtype=torch.int32))
    assert len(j_leaves) == len(t_map), name
    for path, leaf in j_leaves:
        key = tuple(str(getattr(p, "key", p)) for p in path)
        want = np.asarray(leaf)
        got = t_map[key]
        assert str(got.dtype).split(".")[-1] == str(want.dtype), (name, key)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{name} {key}")


@pytest.fixture(scope="module")
def granularity():
    with open(GOLDEN) as f:
        golden = json.load(f)
    return {n: g["granularity"] if g["accepted"] else 8 for n, g in golden.items()}


@pytest.mark.parametrize("name", NAMES)
def test_parallel_value_matches_jax_serial(data, granularity, name):
    """The port's restructured iteration at the adviser's granularity (8
    for the rejected Fraud) against the JAX serial iteration."""
    jd, td = data[name]
    want = J_BENCH[name].serial_value(jd)
    got = T_BENCH[name].parallel_value(td, granularity=granularity[name])
    _assert_same(got, want, name)
    # the declared combine (a sum over the items) as well
    got_sum = T_BENCH[name].parallel_value(td, granularity=granularity[name], combine="sum")
    want_sum = np.asarray(want).sum(0)
    np.testing.assert_allclose(got_sum.numpy(), want_sum, rtol=1e-4, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("name", NAMES)
def test_port_serial_value_matches_jax(data, name):
    """The port's serial semantics (a Python loop, item after item) on the
    first 64 items against the JAX serial iteration's."""
    jd, td = data[name]
    want = np.asarray(J_BENCH[name].serial_value(jd))[:64]
    _assert_same(T_BENCH[name].serial_value(td, limit=64), want, name)


@pytest.mark.parametrize("mod", [(j_pfl, t_pfl), (j_cc, t_cc)], ids=["pfl", "cc"])
def test_sweep_kernels_restructure_like_jax(mod):
    """pfl (Fig. 1) and cc (Fig. 2): relic_pfor over the port's per-item
    function against the JAX per-item function mapped item after item, at
    a granularity that pads; and their microtasks are the JAX ones."""
    jm, tm = mod
    jd, td = jm.build(), tm.build(device="cpu")
    want = np.asarray(jax.lax.map(jm.item_fn(jd), jm.items(jd)))
    got = relic_pfor(tm.item_fn(td), tm.items(td), granularity=7)
    _assert_same(got, want, jm.__name__)
    assert tm.microtask().__dict__ == jm.microtask().__dict__


def test_fig34_geomeans_match_bench_file():
    """The port's Figs. 3–4 runner (no timing) gives the decisions of the
    golden file and BENCH_aira.json's two geomeans within 1e-6."""
    clear_plan_cache()
    with open(os.path.join(ROOT, "BENCH_aira.json")) as f:
        bench = json.load(f)
    lines = []
    rows, gm_pos, gm_all = fig34.run(print_fn=lines.append, timing=False, device="cpu")
    assert abs(gm_pos - bench["geomean_positive"]) <= 1e-6
    assert abs(gm_all - bench["geomean_all_discard_negative"]) <= 1e-6
    by_name = {b["name"]: b for b in bench["benchmarks"]}
    for r in rows:
        want = by_name[r["name"]]
        assert r["accepted"] == want["accepted"] and r["regressed"] == want["regressed"]
        assert r["realized"] == pytest.approx(want["realized_gain_model"], rel=1e-9)
    assert lines[-1].startswith("successfully parallelized 7/10")
