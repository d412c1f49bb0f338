"""The port stands alone: ``repro_torch`` (serving, the adviser and
training) and ``chip_smoke.py`` import neither ``jax`` nor anything of the
JAX package ``repro``, and import with no CUDA device visible."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b(?!_torch)|from\s+repro\.)", re.M)


def test_port_imports_with_jax_and_repro_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]\n"
        "import repro_torch.serve.engine, repro_torch.models.model, repro_torch.kernels.ops\n"
        "import repro_torch.models.ssm, repro_torch.kernels.ssd_scan\n"
        "import repro_torch.kernels.relic_matmul, repro_torch.kernels.decode_attention\n"
        "import repro_torch.serve, repro_torch.configs, repro_torch.configs.zamba2_2p7b\n"
        "import repro_torch.configs.stablelm_3b, repro_torch.configs.phi3_medium_14b\n"
        "import repro_torch.configs.internlm2_20b, repro_torch.configs.granite_moe_1b\n"
        "import repro_torch.configs.internvl2_2b, repro_torch.configs.musicgen_large\n"
        "import repro_torch.configs.dbrx_132b, repro_torch.models.moe\n"
        "import repro_torch.serve.speculative, repro_torch.serve.scheduler\n"
        "import repro_torch.serve.controller, repro_torch.serve.telemetry\n"
        "import repro_torch.serve.kv_cache, repro_torch.serve.load\n"
        "import repro_torch.core, repro_torch.core.deps, repro_torch.core.spec\n"
        "import repro_torch.bench_suite, repro_torch.bench_suite.fig34\n"
        "import repro_torch.bench_suite.pfl, repro_torch.bench_suite.cc\n"
        "import repro_torch.parallel, repro_torch.parallel.sharding\n"
        "import repro_torch.parallel.collectives, repro_torch.launch.mesh\n"
        "import repro_torch.serve.differential\n"
        "import repro_torch.train, repro_torch.train.optimizer, repro_torch.train.train_step\n"
        "import repro_torch.train.trainer, repro_torch.data, repro_torch.data.pipeline\n"
        "import repro_torch.ckpt, repro_torch.ckpt.checkpoint, repro_torch.tree\n"
        "import repro_torch.parallel.compression, repro_torch.parallel.pipeline\n"
        "import repro_torch.core.profiler, repro_torch.core.op_cost\n"
        "import repro_torch.core.op_analysis, repro_torch.kernels.work\n"
        "import repro_torch.launch.cells, repro_torch.launch.dryrun\n"
        "import repro_torch.examples.serve_decode, repro_torch.examples.train_smollm\n"
        "import repro_torch.examples.quickstart, repro_torch.examples.parallelize_with_aira\n"
        "import chip_smoke\n"
        "assert 'jax' not in [m.split('.')[0] for m, v in sys.modules.items() if v is not None]\n"
        "import torch\n"
        "assert not torch.cuda.is_available()\n"
        "assert not torch.distributed.is_initialized()  # the dry run opens its group itself\n"
    )
    # no CUDA device visible: the port imports without one
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT,
                       env=env)
    assert r.returncode == 0, r.stderr


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import_in_source(path):
    hits = FORBIDDEN.findall(path.read_text())
    assert not hits, f"{path.relative_to(ROOT)} imports {hits}"


EXAMPLES = ["repro_torch.examples", "repro_torch.examples.serve_decode",
            "repro_torch.examples.train_smollm", "repro_torch.examples.quickstart",
            "repro_torch.examples.parallelize_with_aira"]
EXAMPLE_FORBIDDEN = re.compile(r"^\s*(import\s+benchmarks\b|from\s+benchmarks\b)", re.M)


@pytest.mark.parametrize("module", EXAMPLES)
def test_entry_point_imports_alone(module):
    """Each entry point imports, and builds what its command line reaches,
    with ``jax``, ``repro`` and ``benchmarks`` blocked and no CUDA device
    visible; its source names none of them."""
    path = ROOT / "src" / Path(*module.split("."))
    path = path / "__init__.py" if path.is_dir() else path.with_suffix(".py")
    text = path.read_text()
    assert not FORBIDDEN.findall(text) and not EXAMPLE_FORBIDDEN.findall(text)
    code = (
        "import importlib, sys\n"
        "for name in ('jax', 'repro', 'benchmarks'):\n"
        "    sys.modules[name] = None\n"
        f"sys.path[:0] = [{str(ROOT / 'src')!r}]\n"
        f"mod = importlib.import_module({module!r})\n"
        "if hasattr(mod, 'build_parser'):\n"
        "    mod.build_parser().parse_args([])\n"
        "loaded = {m.split('.')[0] for m, v in sys.modules.items() if v is not None}\n"
        "assert not loaded & {'jax', 'repro', 'benchmarks'}, loaded\n"
    )
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT,
                       env=env)
    assert r.returncode == 0, r.stderr
