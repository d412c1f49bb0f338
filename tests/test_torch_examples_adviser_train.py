"""The port's adviser and training entry points against the JAX package's
on the CPU: ``repro_torch.examples.quickstart`` prints the JAX script's
decision, schedule and granularity band (both scripts' stdout compared
line for line); ``parallelize_with_aira`` on the JAX script's centroids
and queries gives JAX's argmin indices exactly, on fresh items too, and
the JAX script's plan-cache stats; ``train_smollm`` (``--steps 60 --batch
2 --seq 16``), stopped after its step-50 checkpoint and run again over the
same directory, ends bitwise equal to an uninterrupted run, and its first
loss from the JAX weights and the JAX package's first batch is within
1e-5 of the JAX ``Trainer``'s; with no CUDA and no ``--device cpu`` each
command exits non-zero."""
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.core.plan import clear_plan_cache as j_clear_plan_cache
from repro.data import SyntheticLMData as JData
from repro.models import Model as JModel
from repro.train import AdamW as JAdamW
from repro.train import Trainer as JTrainer
from repro.train import TrainerConfig as JTrainerConfig
from repro_torch.configs import get_config as tget
from repro_torch.core.plan import clear_plan_cache
from repro_torch.examples import parallelize_with_aira, quickstart, train_smollm
from repro_torch.models.model import Model as TModel
from repro_torch.tree import flatten

ROOT = Path(__file__).resolve().parents[1]
LOSS_ATOL = 1e-5
TRAIN_ARGV = ["--steps", "60", "--batch", "2", "--seq", "16"]


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_prints_the_jax_decision_and_band(capsys):
    j_clear_plan_cache()
    _jax_script("quickstart").main()
    want = capsys.readouterr().out.splitlines()
    clear_plan_cache()
    got = quickstart.main([], device="cpu")
    lines = capsys.readouterr().out.splitlines()
    # the report's stage log counts each package's own ops; the decision,
    # the check against the serial loop and the band are the same lines
    keep = ("restructured == serial", "chosen schedule", "CC kernel", "  n=")
    assert [x for x in lines if x.startswith(keep)] == [x for x in want if x.startswith(keep)]
    assert "restructured == serial: True" in lines and got["equal"]
    assert len(got["band"]) == 4 and lines[1].startswith("[ACCEPT] GeoSpatial")
    assert want[1].split("|")[0] == lines[1].split("|")[0]


def test_parallelize_with_aira_gives_the_jax_indices(capsys):
    j_clear_plan_cache()
    _jax_script("parallelize_with_aira").main()
    want = capsys.readouterr().out.splitlines()
    centroids = jax.random.normal(jax.random.key(0), (512, 32))
    queries = jax.random.normal(jax.random.key(1), (2048, 32))
    more = jax.random.normal(jax.random.key(2), (2048, 32))

    def nearest(q):
        return jnp.argmin(jnp.sum((centroids - q[None, :]) ** 2, axis=1))

    clear_plan_cache()
    got = parallelize_with_aira.main([], device="cpu", centroids=np.asarray(centroids),
                                     queries=np.asarray(queries), more_queries=np.asarray(more))
    lines = capsys.readouterr().out.splitlines()
    np.testing.assert_array_equal(got["indices"], np.asarray(jax.vmap(nearest)(queries)))
    np.testing.assert_array_equal(got["more_indices"], np.asarray(jax.vmap(nearest)(more)))
    assert got["reused"] and got["cache"] == {"hits": 1, "misses": 1, "size": 1}
    assert lines[-1] == want[-1]  # "plan reused on new items; cache: {...}"
    assert want[1].split("|")[0] == lines[1].split("|")[0]  # decision and schedule


def test_train_resumes_bitwise_after_its_step_50_checkpoint(tmp_path, capsys):
    full = train_smollm.main(TRAIN_ARGV + ["--ckpt", str(tmp_path / "a")], device="cpu")
    ckpt = TRAIN_ARGV + ["--ckpt", str(tmp_path / "b")]
    with pytest.raises(RuntimeError, match="induced node failure at step 55"):
        train_smollm.main(ckpt, device="cpu", fail_at_step=55)
    resumed = train_smollm.main(ckpt, device="cpu")
    out = capsys.readouterr().out
    # the step-50 checkpoint, or a later one the straggler watchdog saved
    first = resumed["first_step"]
    assert 50 <= first <= 55 and resumed["events"] == [f"restored step {first}"]
    assert f"[trainer] restored checkpoint at step {first}" in out
    assert resumed["step"] == full["step"] == 60
    assert resumed["losses"] == full["losses"][first:] and resumed["loss"] == full["loss"]
    for a, b in zip(flatten(resumed["state"].params)[0], flatten(full["state"].params)[0]):
        assert torch.equal(a, b)
    assert f"done: step 60, loss {full['loss']:.4f} (checkpoints in {tmp_path / 'a'})" in out
    assert full["losses"][-1] == full["loss"] and len(full["losses"]) == 60


class _Batches:
    """The JAX package's batches, as the port's trainer takes them."""

    def __init__(self, data):
        self.data = data

    def batch_at(self, step):
        return {k: torch.from_numpy(np.array(v)) for k, v in self.data.batch_at(step).items()}


def test_first_loss_matches_the_jax_trainer(tmp_path):
    cfg = jget("smollm-135m").reduced()
    data = JData(cfg, batch=2, seq=16)
    trainer = JTrainer(JModel(cfg), JAdamW(lr=3e-4, warmup_steps=20, total_steps=1), data,
                       JTrainerConfig(total_steps=1, ckpt_every=50, ckpt_dir=str(tmp_path / "j"),
                                      log_every=20), log_fn=lambda m: None)
    state = trainer.init_state()
    _, metrics = trainer.run(state)
    bridged = TModel(tget("smollm-135m").reduced(), device="cpu").params_from_reference(
        jax.tree.map(np.asarray, state.params))
    got = train_smollm.main(["--steps", "1", "--batch", "2", "--seq", "16",
                             "--ckpt", str(tmp_path / "t")], device="cpu",
                            params=bridged, data=_Batches(data))
    assert abs(got["losses"][0] - float(metrics["loss"])) <= LOSS_ATOL


@pytest.mark.parametrize("name", ["train_smollm", "quickstart", "parallelize_with_aira"])
def test_command_without_a_card_exits_nonzero(name):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    r = subprocess.run([sys.executable, "-m", f"repro_torch.examples.{name}"],
                       capture_output=True, text=True, cwd=ROOT, env=env)
    assert r.returncode != 0
    assert "no CUDA device is available" in r.stderr and r.stdout == ""
