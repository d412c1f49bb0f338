"""``prefill_pad_share``: the program's own count of the pads its prefills
computed, read by the tiny cell's traced run on the CPU; exact on known
counts; nothing read from a program that keeps none, nor at ``--trace 0``,
where the harness builds the scheduler with the recorder off."""
import json
from types import SimpleNamespace

import pytest

import benchtest
from pbench.manifest import Manifest

MANIFEST = json.loads((benchtest.ROOT / "BENCHMARK.json").read_text())


def test_the_share_reads_internlm2s_cells():
    """Every ``prefill_pad_share.*`` entry resolves to this reader and lists
    cells of internlm2, a family that pads its prompts."""
    config = {w["name"]: w["config"] for w in MANIFEST["workloads"]}
    entries = [m for m in MANIFEST["per_layer"] if m["name"].startswith("prefill_pad_share.")]
    assert entries
    man = Manifest()
    for m in entries:
        assert man.reader(m["name"]).__module__ == "metrics.prefill_pad_share"
        assert m["workloads"] and all(config[w].startswith("internlm2") for w in m["workloads"])


def _run(*reqs, w0=1.0, t_clean=3.0):
    requests = [SimpleNamespace(handle=h, stamps=stamps) for h, stamps in reqs]
    return SimpleNamespace(requests=requests, w0=w0, t_clean=t_clean)


def _handle(real, pad):
    return SimpleNamespace(prefill_tokens=real, prefill_pad=pad)


def test_share_is_exact_over_the_untraced_part():
    read = Manifest().reader("prefill_pad_share.itl")
    run = _run((_handle(9, 7), [1.5, 1.6]),  # 9 tokens at width 16
               (_handle(2048, 0), [2.9]),
               (_handle(100, 28), [0.5, 1.2]),  # first token before the window
               (_handle(3000, 1096), [3.0]),  # first token in the traced slice
               (None, []))  # not admitted
    assert read(run) == pytest.approx(7 / (9 + 7 + 2048) * 100)
    assert read(_run((_handle(0, 0), [0.1]))) is None


def test_a_program_without_the_counts_reads_nothing():
    read = Manifest().reader("prefill_pad_share.docs")
    assert read(_run((SimpleNamespace(prefix_hit=0), [1.5]))) is None


@pytest.fixture
def checkout(tmp_path):
    return benchtest.tiny_checkout(tmp_path, "dense")


def test_traced_run_reads_the_share(checkout):
    res = benchtest.run_cpu(checkout, seed=2**31 + 7, seconds=2.0, trace=1)
    assert res["correct"], res["checks"]
    share = res["metrics"]["prefill_pad_share.itl"]
    assert share["unit"] == "%" and 0 < share["value"] < 50


def test_untraced_run_reads_no_layer(checkout, monkeypatch):
    from repro_torch.serve import scheduler

    def refuse(*a, **k):
        raise AssertionError("the harness's scheduler recorded a step")

    monkeypatch.setattr(scheduler, "StepTrace", refuse)
    res = benchtest.run_cpu(checkout, seed=2**31 + 7, seconds=1.0, trace=0)
    assert res["correct"], res["checks"]
    assert not any(m.startswith("prefill_pad_share.") for m in res["metrics"])
