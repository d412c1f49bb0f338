"""The port's data-parallel training, gradient compression and 2-stage
pipeline against the JAX package on the CPU, in one group of 8 gloo rank
processes (``run_ranks``; bodies in ``tests/_torch_train_ranks.py``): the
cases of ``tests/test_sharded.py`` — the sharded train step on the JAX
test's ("data", "model") = (2, 4) mesh against the JAX single-device step
(loss within 5e-3, parameters within 5e-2), ``compressed_psum`` over a
2-rank "pod" axis, the two-stage pipeline (L = 4, D = 8, B = 16, 4
microbatches, atol 1e-5) on the JAX test's weights and input — one
``step_compressed`` call on 2 pod ranks against the plain step, and a mask
whose "data" shards keep 3 and 64 positions, on smollm-135m and on a MoE:
the data-parallel loss is the global masked mean, as the JAX step's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jget
from repro.data import SyntheticLMData as JData
from repro.models import Model as JModel
from repro.train import AdamW as JAdamW
from repro.train import make_train_step as jmake_train_step
from repro_torch.configs import get_config as tget
from repro_torch.data import SyntheticLMData as TData
from repro_torch.launch.mesh import run_ranks
from repro_torch.tree import flatten

import _torch_train_ranks as ranks

LOSS_ATOL = 5e-3  # tests/test_sharded.py's
PARAM_ATOL = 5e-2  # tests/test_sharded.py's
PIPE_ATOL = 1e-5  # tests/test_sharded.py's
DP_RTOL = 1e-5  # the data-parallel step against the port's single-device one
# the reduced MoE has 4 experts, top-2: at E / k every expert takes all T
# tokens of a call, so nothing drops on a shard or on one device
MOE_CAPACITY_FACTOR = 2.0


@pytest.fixture(scope="module")
def reference():
    """The JAX test's reduced smollm-135m, batch and single-device step."""
    cfg = jget("smollm-135m").reduced()
    m = JModel(cfg)
    params, _ = m.init(jax.random.key(0))
    batch = JData(cfg, batch=4, seq=32).batch_at(0)
    opt = JAdamW(lr=1e-3, warmup_steps=2, total_steps=10)
    step = jax.jit(jmake_train_step(m, opt))
    p1, _, met1 = step(params, opt.init(params), batch)
    uneven = dict(batch, mask=jnp.asarray(_uneven_mask(np.asarray(batch["mask"]))))
    _, _, met_u = step(params, opt.init(params), uneven)
    return {"params": jax.tree.map(np.asarray, params),
            "batch": {k: np.asarray(v) for k, v in batch.items()},
            "uneven": {k: np.asarray(v) for k, v in uneven.items()},
            "loss": float(met1["loss"]), "loss_uneven": float(met_u["loss"]),
            "stepped": [np.asarray(x, np.float32) for x in flatten(p1)[0]]}


def _uneven_mask(mask):
    """``mask`` [B, S] with the first "data" shard (rows < B/2) keeping 3
    positions of its first row and the second keeping all of its own: the
    mean of the two shards' masked means is then far from the global
    masked mean."""
    mask = np.array(mask, np.float32)
    mask[: mask.shape[0] // 2] = 0
    mask[0, :3] = 1
    return mask


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
    moe_batch = {k: np.asarray(v) for k, v in
                 TData(tget("granite-moe-1b-a400m").reduced(), batch=4, seq=32,
                       device="cpu").batch_at(0).items()}
    moe_batch["mask"] = _uneven_mask(moe_batch["mask"])
    todo = [
        ("dp", "dp_step", ((2, 4), ("data", "model"), reference["params"], reference["batch"])),
        ("dp_uneven", "dp_step", ((2, 4), ("data", "model"), reference["params"],
                                  reference["uneven"])),
        ("dp_moe", "dp_moe", (MOE_CAPACITY_FACTOR, moe_batch)),
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


def test_dp_step_weights_tokens_not_ranks(cases, reference):
    """A mask whose "data" shards keep 3 and 64 positions: the data-parallel
    step's loss is the global masked mean, as the JAX single-device step's
    is (``LOSS_ATOL``), and its loss and ``grad_norm`` equal the port's
    single-device step's within ``DP_RTOL``; a mean of the two shards'
    means would be far from both."""
    found = _case(cases, "dp_uneven")
    mesh, single = found["mesh"], found["single"]
    assert mesh["tokens"] == single["tokens"] == 3 + 2 * 32
    assert abs(mesh["loss"] - reference["loss_uneven"]) < LOSS_ATOL, (
        mesh["loss"], reference["loss_uneven"])
    assert abs(mesh["loss"] - single["loss"]) <= DP_RTOL * single["loss"], (
        mesh["loss"], single["loss"])
    assert abs(mesh["grad_norm"] - single["grad_norm"]) <= DP_RTOL * single["grad_norm"], (
        mesh["grad_norm"], single["grad_norm"])


def test_dp_step_weights_tokens_moe(cases):
    """The uneven mask on a reduced MoE at a capacity factor where nothing
    drops: the data-parallel ``ce`` is the single-device ``ce`` within
    ``DP_RTOL``; the aux loss stays the shards' mean (the JAX package's
    ``pmean`` convention), so only ``ce`` is held to one device."""
    found = _case(cases, "dp_moe")
    mesh, single = found["mesh"], found["single"]
    assert mesh["tokens"] == single["tokens"] == 3 + 2 * 32
    assert abs(mesh["ce"] - single["ce"]) <= DP_RTOL * single["ce"], (mesh["ce"], single["ce"])
    assert np.isfinite(mesh["aux"]) and mesh["aux"] > 0


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
