"""What the benchmark runs imports neither JAX nor the JAX package, and the
reference imports nothing of the program: by the sources' imports, and by
the modules a process holds."""
import ast
import subprocess
import sys

import pytest

import benchtest

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


SOURCES = sorted(p for p in benchtest.BENCH.rglob("*.py")
                 if "__pycache__" not in p.parts and not p.name.startswith("test_"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(benchtest.BENCH)))
def test_no_forbidden_top_level_import(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & FORBIDDEN
    if "reference" in path.parts:
        assert "repro_torch" not in tops


def test_guard_compares_whole_top_level_names():
    code = ("import sys; sys.path.insert(0, %r); import run; "
            "sys.modules['repro_torch_x'] = sys; sys.modules['repro_torch.a'] = sys; "
            "print(run.forbidden_modules()); "
            "sys.modules['repro.models'] = sys; print(run.forbidden_modules())"
            % str(benchtest.BENCH))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True).stdout.split("\n")
    assert out[0] == "[]" and out[1] == "['repro']"


def test_reference_and_harness_load_no_program_or_jax():
    code = ("import sys; sys.path[:0] = [%r]; "
            "import reference.dense, reference.moe, reference.check, pbench.work, "
            "pbench.traffic, pbench.stats; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'repro', 'repro_torch'}))" % str(benchtest.BENCH))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True).stdout.strip()
    assert out == "[]"


def test_no_result_without_a_card_or_the_program(tmp_path):
    """Without CUDA the run prints nothing on standard output and exits
    with a code other than 0; so it does in a directory that holds only
    BENCHMARK.json and the benchmark."""
    import shutil

    shutil.copytree(benchtest.BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(benchtest.ROOT / "BENCHMARK.json", tmp_path)
    args = ["--workload", "internlm2-chat", "--seed", "1", "--seconds", "1", "--trace", "0"]
    for root in (tmp_path, benchtest.ROOT):
        p = subprocess.run([sys.executable, "bench/run.py", *args], cwd=root,
                           capture_output=True, text=True, timeout=120,
                           env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
        assert p.returncode != 0 and p.stdout == ""
