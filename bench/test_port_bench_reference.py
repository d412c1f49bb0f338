"""The plain reference and the frozen arithmetic against the program's own
reference route and counts, at reduced sizes on the CPU."""
import json

import pytest
import torch

import benchtest
from pbench import weights, work
from reference import check, dense, moe


def _model(family):
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models.model import Model

    m = dict(benchtest.TINY_MODEL[family])
    cfg_file = "granite-moe-1b-a400m" if family == "moe" else "internlm2-20b"
    init = json.loads((benchtest.BENCH / "configs" / f"{cfg_file}.json").read_text())["init"]
    model = Model(ModelConfig(**m), device="cpu")
    params = weights.make(model.abstract_params()[0], m, init, 2**31 + 7, torch.device("cpu"))
    return m, model, params


@pytest.mark.parametrize("family", ["dense", "moe"])
def test_reference_logits_match_the_programs_reference_route(family):
    m, model, params = _model(family)
    toks = torch.randint(0, m["vocab_size"], (2, 40), generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        x, _ = model.forward(params, toks, backend="reference")
        want = (x @ model._head(params)).float()[..., :m["vocab_size"]]
    ref = {"dense": dense, "moe": moe}[family]
    got = ref.forward_logits(params, m, [(toks[i], 0) for i in range(2)])
    for i in range(2):
        torch.testing.assert_close(got[i], want[i], rtol=1e-4, atol=1e-4)


def test_weights_deterministic_and_padding_zero():
    m, model, a = _model("dense")
    _, _, b = _model("dense")
    for (pa, ta), (pb, tb) in zip(weights.leaves(a), weights.leaves(b)):
        assert pa == pb and torch.equal(ta, tb)
    assert a["embed"].shape[0] > m["vocab_size"]
    assert not a["embed"][m["vocab_size"]:].any() and not a["lm_head"][:, m["vocab_size"]:].any()
    assert torch.equal(a["final_norm"], torch.ones_like(a["final_norm"]))


def test_gaps_and_the_control():
    logits = torch.tensor([[1.0, 3.0, 2.0], [0.5, 0.1, 0.2]])
    assert check.gaps(logits, [2, 0]).tolist() == [1.0, 0.0]
    assert check.gaps(logits, [5, 0])[0] == float("inf")
    x = torch.randn(64, 32)
    q = dense.fp8(x, -1)
    rel = ((q - x).abs() / x.abs().amax(-1, keepdim=True)).max()
    assert 0 < rel < 2 ** -3  # e4m3: 3 mantissa bits


@pytest.mark.parametrize("lens,T", [([0, 15, 16, 2032, 7, 100, 1, 64], 1), ([3, 900], 5)])
def test_paged_work_matches_the_programs_count(lens, T):
    from repro_torch.kernels import work as pw

    B, H, KV, hd, BS, MB = len(lens), 48, 8, 128, 16, 128
    q = torch.empty(B, T, H, hd, dtype=torch.bfloat16)
    pool = torch.empty(4, BS, KV, hd, dtype=torch.bfloat16)
    tables = torch.zeros(B, MB, dtype=torch.int32)
    want = pw.paged(q, pool, tables, torch.tensor(lens, dtype=torch.int32))
    got = work.paged_decode(lens, n_heads=H, n_kv_heads=KV, head_dim=hd, T=T,
                            table_entries=B * MB)
    assert got.flops == want.flops and got.bytes == want.bytes


def test_flash_work_matches_the_programs_count():
    from repro_torch.kernels import work as pw

    q = torch.empty(1, 1000, 48, 128, dtype=torch.bfloat16)
    k = torch.empty(1, 1000, 8, 128, dtype=torch.bfloat16)
    want = pw.flash(q, k)
    got = work.flash_prefill(1000, n_heads=48, n_kv_heads=8, head_dim=128)
    assert got.flops == want.flops and got.bytes == want.bytes


@pytest.mark.parametrize("name", ["internlm2-20b", "granite-moe-1b-a400m"])
def test_model_flops_from_the_configs_shapes(name):
    from repro_torch.configs.base import ModelConfig

    m = json.loads((benchtest.BENCH / "configs" / f"{name}.json").read_text())["model"]
    cfg = ModelConfig(**m)
    # the program's active count holds the padded vocabulary, norms and the
    # embedding (twice, untied); the benchmark counts products only
    embed = cfg.padded_vocab * cfg.d_model
    norms = cfg.d_model * (2 * cfg.num_layers + 1)
    head = 0 if cfg.tie_embeddings else embed - cfg.d_model * cfg.vocab_size
    want = cfg.active_param_count() - embed - norms - head
    if cfg.tie_embeddings:
        want += cfg.d_model * cfg.vocab_size
    want -= cfg.num_layers * cfg.d_model * cfg.n_experts  # router: counted below
    got = work.matmul_params_per_token(m) - cfg.num_layers * cfg.d_model * cfg.n_experts
    assert got == want
    assert work.forward_flops(m, 10, 5) == 2 * work.matmul_params_per_token(m) * 10 + \
        4 * m["head_dim"] * m["n_heads"] * (10 * 5 + 55) * m["num_layers"]
