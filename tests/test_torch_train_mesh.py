"""The port's data-parallel training, gradient compression and 2-stage
pipeline against the JAX package on the CPU, in one group of 8 gloo rank
processes (``run_ranks``; bodies in ``tests/_torch_train_ranks.py``): the
cases of ``tests/test_sharded.py`` — the sharded train step on the JAX
test's ("data", "model") = (2, 4) mesh against the JAX single-device step
(loss within 5e-3, parameters within 5e-2), ``compressed_psum`` over a
2-rank "pod" axis, the two-stage pipeline (L = 4, D = 8, B = 16, 4
microbatches, atol 1e-5) on the JAX test's weights and input — and one
``step_compressed`` call on 2 pod ranks against the plain step."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jget
from repro.data import SyntheticLMData as JData
from repro.models import Model as JModel
from repro.train import AdamW as JAdamW
from repro.train import make_train_step as jmake_train_step
from repro_torch.launch.mesh import run_ranks
from repro_torch.tree import flatten

import _torch_train_ranks as ranks

LOSS_ATOL = 5e-3  # tests/test_sharded.py's
PARAM_ATOL = 5e-2  # tests/test_sharded.py's
PIPE_ATOL = 1e-5  # tests/test_sharded.py's


@pytest.fixture(scope="module")
def reference():
    """The JAX test's reduced smollm-135m, batch and single-device step."""
    cfg = jget("smollm-135m").reduced()
    m = JModel(cfg)
    params, _ = m.init(jax.random.key(0))
    batch = JData(cfg, batch=4, seq=32).batch_at(0)
    opt = JAdamW(lr=1e-3, warmup_steps=2, total_steps=10)
    p1, _, met1 = jax.jit(jmake_train_step(m, opt))(params, opt.init(params), batch)
    return {"params": jax.tree.map(np.asarray, params),
            "batch": {k: np.asarray(v) for k, v in batch.items()},
            "loss": float(met1["loss"]),
            "stepped": [np.asarray(x, np.float32) for x in flatten(p1)[0]]}


def _pipeline_inputs():
    L, D, B = 4, 8, 16
    ws = jax.random.normal(jax.random.key(0), (L, D, D)) * 0.3
    x = jax.random.normal(jax.random.key(1), (B, D))

    def layer_fn(sp, x):
        def bd(x, w):
            return jnp.tanh(x @ w), None

        y, _ = jax.lax.scan(bd, x, sp)
        return y

    want = layer_fn(ws[2:], layer_fn(ws[:2], x))
    return np.asarray(ws), np.asarray(x), np.asarray(want)


@pytest.fixture(scope="module")
def cases(tmp_path_factory, reference):
    ws, x, _ = _pipeline_inputs()
    g = np.asarray(jax.random.normal(jax.random.key(2), (64,)))
    todo = [
        ("dp", "dp_step", ((2, 4), ("data", "model"), reference["params"], reference["batch"])),
        ("compressed_step", "step_compressed", (reference["params"], reference["batch"])),
        ("compress", "compress", (g,)),
        ("pipeline", "pipeline", (ws, x, 4)),
    ]
    out = tmp_path_factory.mktemp("train_mesh")
    run_ranks(ranks.run_cases, 8, todo, str(out), store=str(out / "store"), timeout_s=120.0)
    found = ranks.load(str(out), 0)
    found["g"] = g
    return found


def _case(cases, name):
    found = cases[name]
    assert "error" not in found, found.get("error")
    return found


def _max_diff(a, b):
    return max(float(np.abs(x - y).max()) for x, y in zip(a, b))


def test_sharded_train_step_matches_single_device(cases, reference):
    """``tests/test_sharded.py::test_sharded_train_step_matches_single_device``
    on the port: the batch split over "data" (2), replicated over "model"
    (4), the gradients averaged; against the JAX single-device step and
    the port's own."""
    found = _case(cases, "dp")
    mesh, single = found["mesh"], found["single"]
    assert abs(mesh["loss"] - reference["loss"]) < LOSS_ATOL, (mesh["loss"], reference["loss"])
    assert abs(mesh["loss"] - single["loss"]) <= 1e-5 * single["loss"]
    assert mesh["tokens"] == single["tokens"] == 4 * 32
    assert _max_diff(mesh["params"], reference["stepped"]) < PARAM_ATOL
    assert _max_diff(mesh["params"], single["params"]) < PARAM_ATOL
    assert _max_diff(single["params"], reference["stepped"]) < PARAM_ATOL


def test_compressed_psum_pod_axis(cases):
    """``tests/test_sharded.py::test_compressed_psum_pod_axis``: a replicated
    input's mean is the dequantized g and the residual its quantization
    error; then ranks holding g and 2g: one shared scale, the int8 sum
    dequantized exactly, the residual fed back on the next step."""
    found, g = _case(cases, "compress"), cases["g"]
    np.testing.assert_allclose(found["mean"] + found["err"], g, atol=1e-6)
    assert float(np.abs(found["err"]).max()) < float(np.abs(g).max()) / 64
    # ranks r = 0, 1 hold g·(1 + r): the shared scale is 2·max|g| / 127
    scale = np.float32(np.abs(2 * g).max() / np.float32(127.0))
    q = [np.clip(np.round(g * (1 + r) / scale), -127, 127) for r in (0, 1)]
    np.testing.assert_allclose(found["mean_r"], (q[0] + q[1]) * scale / 2, rtol=0, atol=1e-6)
    np.testing.assert_allclose(found["err_r"], g - q[0] * scale, atol=1e-6)  # rank 0's
    assert float(np.abs(found["mean_r"] - 1.5 * g).max()) <= scale
    # error feedback: rank 0's second step quantizes g + err
    assert float(np.abs(found["err_r2"]).max()) <= scale / 2 + 1e-6


def test_pipeline_two_stage(cases):
    """``tests/test_sharded.py::test_pipeline_two_stage``'s numbers: the
    JAX test's Ws and x, the 2-stage schedule against the unsplit stack."""
    _, _, want = _pipeline_inputs()
    got = _case(cases, "pipeline")
    np.testing.assert_allclose(got, want, atol=PIPE_ATOL)


def test_step_compressed_matches_plain_step(cases):
    """One ``compress_pod_grads`` step on 2 pod ranks: the loss equals the
    plain step's, the parameters within 5e-2 (the int8 gradient moves each
    weight by Adam's ±lr, like the exact one, but for entries whose
    gradient is below the quantization step)."""
    found = _case(cases, "compressed_step")
    mesh, single = found["mesh"], found["single"]
    assert abs(mesh["loss"] - single["loss"]) <= 1e-5 * single["loss"]
    assert _max_diff(mesh["params"], single["params"]) < PARAM_ATOL
    assert found["err_max"] > 0
