"""Whole runs of a tiny cell on the CPU, the harness's look for a card
skipped: a sound run is correct, and a run whose timed path is broken
underneath, or a run with the control (the reference in float8) in the
program's place, is not. The control fails the cells' own limit at a size
a test run can hold."""
import json

import pytest
import torch

import benchtest

CELLS = {"dense": "internlm2-chat", "moe": "granite-moe-chat"}


GAPS = ("max_logit_gap", "mean_logit_gap")


def _limits(family):
    """The gap limits of the cell of this family's configuration."""
    cell = json.loads((benchtest.BENCH / "cells" / f"{CELLS[family]}.json").read_text())
    return {k: v for k, v in cell["check"].items() if k in GAPS}


@pytest.fixture(params=["dense", "moe"])
def checkout(request, tmp_path):
    path = benchtest.tiny_checkout(tmp_path, request.param)
    cell = json.loads((tmp_path / "bench" / "cells" / "tiny-chat.json").read_text())
    cell["check"] = {k: v for k, v in cell["check"].items() if k not in GAPS}
    cell["check"].update(_limits(request.param))
    (tmp_path / "bench" / "cells" / "tiny-chat.json").write_text(json.dumps(cell))
    return path


def test_sound_run_is_correct(checkout):
    res = benchtest.run_cpu(checkout, seed=2**31 + 99, seconds=2.0)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 10 and res["failed"] == 0
    assert list(res)[-1] == "checks"


def _drop_kv_writes(monkeypatch):
    from repro_torch.models import attention

    monkeypatch.setattr(attention, "scatter_block_token", lambda *a, **k: None)


def _wrap_decode(monkeypatch, edit):
    from repro_torch.models.model import Model

    orig = Model.decode_step_paged

    def decode(self, params, pool, tables, lengths, tokens, **kw):
        logits, pool = orig(self, params, pool, tables, lengths, tokens, **kw)
        return edit(logits.clone(), lengths), pool

    monkeypatch.setattr(Model, "decode_step_paged", decode)


def _half_batch(monkeypatch):
    def edit(logits, lengths):  # every other live row left out, the mean of the rest
        live = (lengths > 0).nonzero()[:, 0]
        if len(live) > 1:
            logits[live[1::2]] = logits[live[0::2]].mean(0)
        return logits

    _wrap_decode(monkeypatch, edit)


def _alter_token(monkeypatch):
    calls = [0]

    def edit(logits, lengths):  # one row's token a step, each row in turn
        logits[calls[0] % logits.shape[0], 3] += 1e3
        calls[0] += 1
        return logits

    _wrap_decode(monkeypatch, edit)


@pytest.mark.parametrize("fault", [_drop_kv_writes, _half_batch, _alter_token],
                         ids=["state_unchanged", "half_batch", "token_altered"])
def test_broken_timed_path_is_not_correct(checkout, monkeypatch, fault):
    fault(monkeypatch)
    res = benchtest.run_cpu(checkout, seed=2**31 + 99, seconds=2.0)
    assert not res["correct"]
    assert any(c["value"] > c["limit"] for k, c in res["checks"].items() if k in GAPS)


def test_control_run_is_not_correct(checkout):
    """With the control on, the control's gaps stand in the program's place
    against the cell's own limits, and the run reads not correct."""
    res = benchtest.run_cpu(checkout, seed=2**31 + 99, seconds=2.0, control=1)
    assert not res["correct"]
    assert any(c["value"] > c["limit"] for k, c in res["checks"].items() if k in GAPS)


class _Handle:
    def __init__(self, admit):
        self.t_first_admit = admit


def test_loop_refuses_a_scheduler_without_a_run_clock():
    from kinds import serve

    with pytest.raises(RuntimeError, match="_t0"):
        serve.Loop(object(), 0.0, align=True)


@pytest.mark.parametrize("admit,ok", [(1.2, True), (1.0, True), (0.9, False), (1.6, False)])
def test_clock_check_reads_admission_between_due_and_first_token(admit, ok):
    from kinds import serve
    from pbench import traffic

    p = traffic.Planned(due=1.0, prompt=torch.zeros(4).numpy(), max_new_tokens=2)
    p.handle, p.stamps = _Handle(admit), [1.5, 1.5]
    loop = serve.Loop(None, 0.0)
    if ok:
        loop.check_clock([p])
    else:
        with pytest.raises(RuntimeError, match="clock"):
            loop.check_clock([p])


@pytest.mark.parametrize("family", ["dense", "moe"])
def test_control_fails_the_limit(family):
    """The reference in float8 against the reference in float32, on
    greedy continuations of random prompts: it fails one of the gap limits
    of the cell of this family, which the float32 continuations meet."""
    from reference import check, dense

    import test_port_bench_reference as t

    m, _, params = t._model(family)
    gen = torch.Generator().manual_seed(11)
    ref = check.reference_for(family)
    served = []
    for _ in range(4):
        prompt = torch.randint(0, m["vocab_size"], (24,), generator=gen).tolist()
        seq = list(prompt)
        for _ in range(16):
            lg = ref.forward_logits(params, m, [(torch.tensor(seq), len(seq) - 1)])[0]
            seq.append(int(lg[-1].argmax()))
        served.append((prompt, seq[len(prompt):]))
    got = check.widest_gap(params, m, served, quant="fp8")
    limits = _limits(family)
    assert all(got[k] <= v for k, v in limits.items())
    assert any(got["control_" + k] > v for k, v in limits.items())
    dense.precise()
