"""The port's checkpointing, trainer and data pipeline on the CPU: the six
cases of ``tests/test_fault_tolerance.py`` (the induced failure and resume
bitwise equal to the uninterrupted run, atomic publish and keep-k
garbage collection, the asynchronous save, the elastic restore's cast, the
straggler watchdog, the compression quantizer), the resume into the
trainer's own state storage with its compiled step's one entry (the JAX
trainer's ``jax.jit`` cache size), a bfloat16 leaf and an
``OptState`` round-tripping bit for bit, and ``SyntheticLMData``: a pure
function of (seed, step), ids below V, the copy share, the vlm shapes and
``batch_specs``."""
import os
import tempfile

import numpy as np
import pytest
import torch

from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLMData
from repro_torch.models.model import Model
from repro_torch.parallel.compression import _quantize
from repro_torch.train import AdamW, Trainer, TrainerConfig
from repro_torch.train.optimizer import OptState
from repro_torch.tree import flatten


def _trainer(tmp, fail_at=None, total=12):
    cfg = get_config("smollm-135m").reduced()
    m = Model(cfg, device="cpu")
    data = SyntheticLMData(cfg, batch=4, seq=32, device="cpu")
    tc = TrainerConfig(total_steps=total, ckpt_every=5, ckpt_dir=str(tmp), log_every=100)
    return Trainer(m, AdamW(lr=1e-3, warmup_steps=2, total_steps=total), data, tc,
                   fail_at_step=fail_at, log_fn=lambda s: None)


def test_induced_failure_and_bitexact_resume(tmp_path):
    # run A: fail at step 7, restart, complete
    tr = _trainer(tmp_path / "a", fail_at=7)
    with pytest.raises(RuntimeError, match="induced node failure"):
        tr.run()
    state_a, _ = tr.run()  # resumes from the step-5 checkpoint
    assert state_a.step == 12
    assert any("restored step 5" in e for e in tr.events)

    # run B: no failure; the same data stream gives the same parameters, bit
    # for bit, and the same optimizer state
    tr_b = _trainer(tmp_path / "b")
    state_b, _ = tr_b.run()
    for a, b in zip(flatten((state_a.params, state_a.opt_state))[0],
                    flatten((state_b.params, state_b.opt_state))[0]):
        assert torch.equal(a, b)


def test_resume_restores_into_the_trainer_storage(tmp_path):
    """The trainer's step is a compiled family over state the trainer owns:
    after the induced failure and the resume, ``step_fn._cache_size()``
    equals the JAX trainer's ``jax.jit`` cache size over the same run, the
    restored state is the same storage (the same addresses before and
    after), and the resumed state is bitwise the uninterrupted run's."""
    from repro.configs import get_config as jget
    from repro.data import SyntheticLMData as JData
    from repro.models import Model as JModel
    from repro.train import AdamW as JAdamW
    from repro.train import Trainer as JTrainer
    from repro.train import TrainerConfig as JTrainerConfig

    jcfg = jget("smollm-135m").reduced()
    jt = JTrainer(JModel(jcfg), JAdamW(lr=1e-3, warmup_steps=2, total_steps=12),
                  JData(jcfg, batch=4, seq=32),
                  JTrainerConfig(total_steps=12, ckpt_every=5, ckpt_dir=str(tmp_path / "jax"),
                                 log_every=100), fail_at_step=7, log_fn=lambda s: None)
    with pytest.raises(RuntimeError, match="induced node failure"):
        jt.run()
    jt.run()

    tr = _trainer(tmp_path / "a", fail_at=7)
    with pytest.raises(RuntimeError, match="induced node failure"):
        tr.run()
    held = [t.data_ptr() for t in flatten((tr._storage.params, tr._storage.opt_state))[0]]
    state_a, _ = tr.run()
    assert state_a.step == 12 and any("restored step 5" in e for e in tr.events)
    assert [t.data_ptr() for t in flatten((state_a.params, state_a.opt_state))[0]] == held
    assert tr.step_fn._cache_size() == jt.step_fn._cache_size() == 1
    state_b, _ = _trainer(tmp_path / "b").run()
    for a, b in zip(flatten((state_a.params, state_a.opt_state))[0],
                    flatten((state_b.params, state_b.opt_state))[0]):
        assert torch.equal(a, b)


def test_checkpoint_atomic_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = {"w": torch.arange(8.0), "b": torch.ones((3,))}
    for s in (1, 2, 3, 4):
        mgr.save(s, tree, blocking=True)
    assert mgr.all_steps() == [3, 4]  # keep-2 GC
    restored, meta = mgr.restore(tree)
    assert meta["step"] == 4
    np.testing.assert_array_equal(restored["w"].numpy(), np.arange(8.0))
    assert not any(p.endswith(".tmp") for p in os.listdir(tmp_path))


def test_async_checkpoint(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    tree = {"w": torch.zeros((1000, 100))}
    mgr.save(10, tree, blocking=False)
    mgr.wait()
    assert mgr.latest_step() == 10


def test_failed_async_save_raises_on_wait(tmp_path):
    """A background save that fails is not lost: the next ``wait()`` (and so
    the next save or restore) raises it."""
    mgr = CheckpointManager(str(tmp_path))
    (tmp_path / "step_00000001.tmp").write_text("")  # a file where its directory goes
    mgr.save(1, {"w": torch.zeros(3)})
    with pytest.raises(RuntimeError, match="checkpoint save"):
        mgr.wait()
    mgr.wait()  # raised once
    assert mgr.all_steps() == []


def test_elastic_restore_dtype_and_structure(tmp_path):
    """A float32 checkpoint restores into a bfloat16 target (the elastic
    path); a meta target restores on the CPU."""
    mgr = CheckpointManager(str(tmp_path))
    tree = {"w": torch.arange(16, dtype=torch.float32).reshape(4, 4)}
    mgr.save(1, tree, blocking=True)
    restored, _ = mgr.restore({"w": torch.zeros((4, 4), dtype=torch.bfloat16)})
    assert restored["w"].dtype == torch.bfloat16
    assert torch.equal(restored["w"], tree["w"].to(torch.bfloat16))
    restored, _ = mgr.restore({"w": torch.empty((4, 4), device="meta")})
    assert restored["w"].device.type == "cpu" and torch.equal(restored["w"], tree["w"])


def test_straggler_watchdog_fires():
    cfg = get_config("smollm-135m").reduced()
    m = Model(cfg, device="cpu")
    data = SyntheticLMData(cfg, batch=2, seq=16, device="cpu")
    with tempfile.TemporaryDirectory() as d:
        tc = TrainerConfig(total_steps=6, ckpt_every=100, ckpt_dir=d,
                           straggler_factor=0.0001, log_every=100)
        t = Trainer(m, AdamW(lr=1e-3, total_steps=6), data, tc, log_fn=lambda s: None)
        t.run()
        assert any("straggler" in e for e in t.events)
        assert len(t.step_times) == 6


def test_gradient_compression_error_feedback():
    g = torch.tensor([0.1, -0.25, 0.003, 1.0])
    scale = torch.max(torch.abs(g)) / 127.0
    q, err = _quantize(g, scale)
    assert q.dtype == torch.int8
    # dequantized + residual reconstructs exactly
    np.testing.assert_allclose((q * scale + err).numpy(), g.numpy(), atol=1e-7)


def test_bf16_leaves_and_opt_state_round_trip_bitwise(tmp_path):
    """bfloat16 leaves (stored as their 16-bit patterns), float32 moments
    and the int32 step of an ``OptState``, in a tree of dicts, lists and
    tuples, come back bit for bit and in their structure."""
    g = torch.Generator().manual_seed(0)
    w = (torch.randn(5, 7, generator=g) * 1e3).to(torch.bfloat16)
    w[0, :4] = torch.tensor([float("inf"), float("-inf"), float("nan"), -0.0])
    params = {"w": w, "norm": torch.ones(7, dtype=torch.bfloat16)}
    opt = AdamW().init(params)
    opt = OptState(step=torch.tensor(7, dtype=torch.int32),
                   mu={k: torch.randn(v.shape, generator=g) for k, v in params.items()},
                   nu=opt.nu)
    tree = {"params": params, "opt": opt, "extra": [torch.arange(3), (torch.zeros(2),)]}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, tree)
    restored, meta = mgr.restore(tree)
    assert isinstance(restored["opt"], OptState) and isinstance(restored["extra"][1], tuple)
    assert "bfloat16" in meta["dtypes"]
    for a, b in zip(flatten(tree)[0], flatten(restored)[0]):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
                           b.view(torch.int16) if b.dtype == torch.bfloat16 else b)


# ---------------------------------------------------------------------------
# the synthetic data


@pytest.mark.parametrize("step", [0, 1, 7, 10_000])
def test_data_pure_function_of_seed_and_step(step):
    """``tests/test_properties.py::test_data_pipeline_deterministic``: two
    pipelines give the same batch for a step, and ids are below V; another
    seed or step gives another batch."""
    cfg = get_config("smollm-135m").reduced()
    a = SyntheticLMData(cfg, batch=2, seq=16, seed=3, device="cpu").batch_at(step)
    b = SyntheticLMData(cfg, batch=2, seq=16, seed=3, device="cpu").batch_at(step)
    for k in a:
        assert torch.equal(a[k], b[k])
    assert int(a["tokens"].max()) < cfg.vocab_size and int(a["tokens"].min()) >= 0
    assert torch.equal(a["labels"][:, :-1], a["tokens"][:, 1:])
    assert a["tokens"].dtype == torch.int32 and torch.equal(a["mask"], torch.ones(2, 16))
    c = SyntheticLMData(cfg, batch=2, seq=16, seed=4, device="cpu").batch_at(step)
    d = SyntheticLMData(cfg, batch=2, seq=16, seed=3, device="cpu").batch_at(step + 1)
    assert not torch.equal(a["tokens"], c["tokens"]) and not torch.equal(a["tokens"], d["tokens"])


def test_data_copy_share_and_unigram():
    """Over a large batch, 0.3 ± 0.05 of the positions copy the unigram id
    of the position before them, and the stream is that mixture; the
    unigram draw favours small ids as the Zipf-flavoured form does."""
    cfg = get_config("smollm-135m")
    d = SyntheticLMData(cfg, batch=64, seq=512, device="cpu")
    b = d.batch_at(0)
    _, zipf, copy = d._draw(0)
    share = float(copy.float().mean())
    assert abs(share - 0.3) <= 0.05, share
    stream = torch.cat([b["tokens"], b["labels"][:, -1:]], dim=1)
    assert torch.equal(stream[copy], torch.roll(zipf, 1, dims=1)[copy])
    assert torch.equal(stream[~copy], zipf[~copy])
    # a repeat needs a copy after a non-copy (0.3 · 0.7), or a collision
    repeat = float((stream[:, 1:] == stream[:, :-1]).float().mean())
    assert 0.2 <= repeat <= 0.25, repeat
    assert int(stream.max()) < cfg.vocab_size
    assert float((zipf < 100).float().mean()) > 0.3  # P(id < 100) = ln 101 / ln V ≈ 0.43


def test_data_vlm_shapes_and_specs():
    cfg = get_config("internvl2-2b").reduced()
    d = SyntheticLMData(cfg, batch=3, seq=20, device="cpu")
    b = d.batch_at(0)
    n_text = 20 - cfg.n_frontend_tokens
    assert b["tokens"].shape == b["labels"].shape == b["mask"].shape == (3, n_text)
    assert b["patch_embeds"].shape == (3, cfg.n_frontend_tokens, cfg.d_model)
    assert b["patch_embeds"].dtype == getattr(torch, cfg.dtype)
    specs = d.batch_specs()
    assert set(specs) == set(b) == set(d.batch_axes())
    for k, v in b.items():
        assert specs[k].is_meta and specs[k].shape == v.shape and specs[k].dtype == v.dtype
    assert d.batch_axes()["patch_embeds"] == ("batch", "seq", None)
