"""The port's serving entry point, ``repro_torch.examples.serve_decode``,
against the JAX package's serving engine on the CPU, float32 at
``.reduced()`` size. The JAX reference streams are computed here, once per
engine setting, with the JAX script's settings (``max_seq=256``, weights
from ``jax.random.key(0)``, the fixed batch's prompts from ``key(1)``,
open-loop requests from ``load.make_requests(rng=default_rng(0))``); the
port's ``main`` takes the same weights and prompts through its hooks.
Every ``examples/serve_decode.py`` invocation of ``.github/workflows/ci.yml``
(``--backend interpret`` as ``reference``: the port has no interpret
backend) and int8 paged serving must give those streams token for token;
speculation's acceptance counts equal JAX's; the trace validates; the
online adviser's audit trail is well formed; ``--mesh 2`` serves on gloo
ranks and gives the single-device streams (``--mesh 3`` falls back to
replicated serving); each exclusion exits with the JAX script's message;
``interpret`` is refused; and with no CUDA and no ``--device cpu`` the
command exits non-zero."""
import dataclasses
import importlib.util
import json
import os
import shlex
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.configs import get_config as jget
from repro.models import Model as JModel
from repro.serve import ServingEngine as JEngine
from repro.serve import SpecConfig as JSpec
from repro.serve import make_requests as j_requests
from repro.serve.telemetry import validate_chrome_trace as j_validate
from repro_torch.configs import get_config as tget
from repro_torch.examples import serve_decode
from repro_torch.models.model import Model as TModel

ROOT = Path(__file__).resolve().parents[1]

# ci.yml's serve_decode invocations, in its order
CI = [
    "--tokens 8",
    "--arch smollm-135m --tokens 8 --open-loop 6 --aira",
    "--arch smollm-135m --tokens 8 --open-loop 6 --paged",
    "--arch smollm-135m --tokens 16 --open-loop 4 --spec 4",
    "--arch smollm-135m --tokens 16 --open-loop 4 --spec 4 --paged",
    "--arch smollm-135m --tokens 8 --open-loop 6 --paged --chunk 16",
    "--arch smollm-135m --tokens 8 --open-loop 4 --paged --backend interpret",
    "--arch smollm-135m --tokens 8 --open-loop 4 --spec 4 --backend interpret",
    "--arch smollm-135m --tokens 8 --open-loop 4 --paged --spec 2 --trace serve_decode_trace.json",
    "--arch smollm-135m --tokens 8 --open-loop 6 --paged --online",
]
INT8 = "--arch smollm-135m --tokens 8 --open-loop 6 --int8-kv --paged"


class JaxReference:
    """The JAX engine at the script's settings for one (arch, int8): its
    weights bridged to the port, its prompts, and its streams per
    (layout, spec K, requests, budget), each served once."""

    def __init__(self, arch: str, int8: bool):
        over = {"kv_quant": True} if int8 else {}
        self.cfg = dataclasses.replace(jget(arch).reduced(), **over)
        self.model = JModel(self.cfg)
        self.params, _ = self.model.init(jax.random.key(0))
        self.prompts = np.asarray(jax.random.randint(jax.random.key(1), (4, 16), 0,
                                                     self.cfg.vocab_size))
        tcfg = dataclasses.replace(tget(arch).reduced(), **over)
        self.bridged = TModel(tcfg, device="cpu").params_from_reference(
            jax.tree.map(np.asarray, self.params))
        self.engines, self.runs = {}, {}

    def engine(self, layout: str, k: int):
        if (layout, k) not in self.engines:
            self.engines[layout, k] = JEngine(
                self.model, self.params, max_seq=256, kv_layout=layout,
                spec=JSpec(k=k, drafter="ngram") if k else None)
        return self.engines[layout, k]

    def run(self, layout: str, k: int, n: int, tokens: int):
        """(streams in request order, serving_summary()) of the open-loop
        run, or of ``generate`` on the prompts when ``n`` is 0."""
        key = (layout, k, n, tokens)
        if key not in self.runs:
            eng = self.engine(layout, k)
            if n == 0:
                out = np.asarray(eng.generate(jax.numpy.asarray(self.prompts), tokens))
                streams = list(out)
            else:
                reqs = j_requests(n, 20.0, vocab=self.cfg.vocab_size, max_new_tokens=tokens,
                                  rng=np.random.default_rng(0))
                got = eng.serve(reqs, max_batch=4)
                streams = [np.asarray(got[r.rid]) for r in reqs]
            self.runs[key] = (streams, eng.stats.serving_summary())
        return self.runs[key]


@pytest.fixture(scope="module")
def refs():
    cache = {}

    def get(arch, int8=False):
        if (arch, int8) not in cache:
            cache[arch, int8] = JaxReference(arch, int8)
        return cache[arch, int8]

    return get


def _argv(line: str, tmp_path) -> list:
    line = line.replace("--backend interpret", "--backend reference")
    line = line.replace("serve_decode_trace.json", str(tmp_path / "trace.json"))
    return shlex.split(line)


def _port_run(refs, argv):
    """The port's ``main`` on the JAX weights and prompts, and the JAX run
    with the same settings."""
    args = serve_decode.build_parser().parse_args(argv)
    ref = refs(args.arch, args.int8_kv)
    got = serve_decode.main(argv, device="cpu", params=ref.bridged, prompts=ref.prompts)
    layout = "paged" if args.paged else "slot"
    want, summary = ref.run(layout, args.spec, args.open_loop, args.tokens)
    return args, got, want, summary


def _assert_streams(got, want, label):
    assert len(got) == len(want), label
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=f"{label}: stream {i} diverged")


@pytest.mark.parametrize("line", CI + [INT8])
def test_ci_invocation_matches_jax_streams(refs, line, tmp_path, capsys):
    args, got, want, summary = _port_run(refs, _argv(line, tmp_path))
    _assert_streams(got["streams"], want, line)
    out = capsys.readouterr().out
    assert out == "".join(line + "\n" for line in got["lines"])
    assert f"arch={args.arch} int8_kv={args.int8_kv} paged={args.paged}" in out
    assert got["backend"] == "reference"
    if args.spec:
        # the n-gram drafter's proposals and the greedy acceptances are
        # the JAX engine's, draft token for draft token
        s, js = got["summary"]["speculative"], summary["speculative"]
        assert (s["k"], s["proposed"], s["accepted"]) == (js["k"], js["proposed"], js["accepted"])
        assert f"speculative: K={args.spec} acceptance=" in out
    if args.aira:
        assert got["aira"]["accepted"] and "decode routed through RegionPlan:" in out
    if args.open_loop:
        assert len(got["requests"]) == args.open_loop
        assert "open-loop serving: steps=" in out
    else:
        assert f"generated (4, {args.tokens}) tokens; first row: " in out


def test_trace_validates_on_both_packages(refs, tmp_path):
    argv = _argv(CI[8], tmp_path)
    got = serve_decode.main(argv, device="cpu", params=refs("smollm-135m").bridged)
    trace = json.loads((tmp_path / "trace.json").read_text())
    counts = j_validate(trace)  # the JAX package's validator on the port's export
    assert counts == got["trace"] and counts["spans"] > 0 and counts["async_spans"] > 0
    names = {e["name"] for e in trace["traceEvents"]}
    assert "step" in names, names
    from repro_torch.serve.telemetry import get_telemetry

    assert not get_telemetry().enabled  # the recorder is disarmed after the run


def test_online_audit_trail_is_well_formed(refs, tmp_path):
    got = serve_decode.main(_argv(CI[9], tmp_path), device="cpu",
                            params=refs("smollm-135m").bridged)
    assert sorted(got["primed"]) == [0, 2, 4] and all(ms > 0 for ms in got["primed"].values())
    audit = got["audit"]
    assert audit and all({"step", "k", "probe", "reason"} <= set(d) for d in audit)
    steps = [d["step"] for d in audit]
    assert steps == sorted(steps) and all(d["k"] in (0, 2, 4) for d in audit)
    info = got["summary"]["controller"]
    assert info["decisions"] == len(audit)
    assert any(line.startswith("online adviser: ") for line in got["lines"])


def test_record_flag_writes_the_run(refs, tmp_path):
    path = tmp_path / "run.json"
    argv = _argv(CI[2], tmp_path) + ["--record", str(path)]
    got = serve_decode.main(argv, device="cpu", params=refs("smollm-135m").bridged)
    rec = json.loads(path.read_text())
    assert rec["streams"] == [s.tolist() for s in got["streams"]]
    assert rec["lines"] == got["lines"] and rec["summary"]["n_requests"] == 6


@pytest.mark.parametrize("n,fallback", [(2, False), (3, True)])
def test_mesh_ranks_give_single_device_streams(refs, n, fallback, tmp_path, capfd):
    """``--mesh N``: N gloo ranks serve the same requests; smollm's 2
    reduced kv heads split over 2 ranks, and over 3 fall back to
    replicated serving with the engine's record."""
    argv = _argv(CI[6], tmp_path) + ["--mesh", str(n)]
    args, got, want, _ = _port_run(refs, argv)
    _assert_streams(got["streams"], want, f"mesh {n}")
    assert len(got["rank_launches"]) == n
    assert bool(got["mesh_fallbacks"]) == fallback
    out = capfd.readouterr().out
    assert out.count("open-loop serving: ") == 1  # rank 0 prints
    assert f" mesh={n}" in out.splitlines()[0]


def _jax_script():
    spec = importlib.util.spec_from_file_location("jax_serve_decode",
                                                  ROOT / "examples" / "serve_decode.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("line", [
    "--arch smollm-135m --spec 4 --aira",
    "--arch smollm-135m --online --aira --open-loop 2",
    "--arch smollm-135m --online",
    "--arch smollm-135m --mesh 2 --open-loop 2",
    "--arch smollm-135m --mesh 2 --paged",
])
def test_exclusions_exit_with_the_jax_message(line, monkeypatch):
    argv = shlex.split(line)
    monkeypatch.setattr(sys, "argv", ["serve_decode.py"] + argv)
    with pytest.raises(SystemExit) as want:
        _jax_script().main()
    with pytest.raises(SystemExit) as got:
        serve_decode.main(argv, device="cpu")
    assert isinstance(want.value.code, str) and got.value.code == want.value.code


def test_interpret_backend_is_refused():
    with pytest.raises(SystemExit) as e:
        serve_decode.main(["--arch", "smollm-135m", "--backend", "interpret"], device="cpu")
    assert e.value.code == serve_decode.INTERPRET_REFUSED and "no interpret backend" in e.value.code


def test_command_without_a_card_exits_nonzero():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    r = subprocess.run([sys.executable, "-m", "repro_torch.examples.serve_decode",
                        "--arch", "smollm-135m", "--tokens", "2"],
                       capture_output=True, text=True, cwd=ROOT, env=env)
    assert r.returncode != 0
    assert "no CUDA device is available" in r.stderr and r.stdout == ""
