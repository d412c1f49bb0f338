"""BENCHMARK.json against the contract's shape, and every name in it found
by file name."""
import json
import re

import pytest

import benchtest
from pbench.manifest import Manifest

MANIFEST = json.loads((benchtest.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|projection|head|expansion"
                   r"|experts_per_tok")


def test_top_level_keys_and_command():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["bench"]
    assert 1 <= len(MANIFEST["command"]) <= 32
    assert all(TEXT.match(w) and not w.startswith("/") and ".." not in w
               for w in MANIFEST["command"])
    assert isinstance(MANIFEST["run_seconds"], int) and 1 <= MANIFEST["run_seconds"] <= 51
    cells = len(MANIFEST["workloads"])
    assert 2 + 14 * 24 * (MANIFEST["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert cells <= 24 and len(json.dumps(MANIFEST)) <= 64 * 1024


def test_names_and_units_use_allowed_characters():
    names = []
    for c in MANIFEST["configs"]:
        names.append(c["name"])
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert TEXT.match(c["source"]) and TEXT.match(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) and not WIDTH.search(k) for k in c["reduced"])
    for w in MANIFEST["workloads"]:
        names.append(w["name"])
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert TEXT.match(w["why"])
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        names.append(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert all(NAME.match(n) for n in names)
    for kind in ("configs", "workloads"):
        got = [x["name"] for x in MANIFEST[kind]]
        assert len(set(got)) == len(got)
    metrics = [m["name"] for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]]
    assert len(set(metrics)) == len(metrics)


def test_metric_entries():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e and 1 <= len(e2e) <= 16
    for m in e2e.values():
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in MANIFEST["workloads"]}
    layers = set()
    for m in MANIFEST["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert TEXT.match(m["layer"]) and m["moves"] in e2e
        for c in m["workloads"]:
            assert c in cells
            assert c in e2e[m["moves"]].get("workloads", [c])
        layers.add(m["layer"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    perf = (benchtest.ROOT / "PERF.md").read_text()
    assert all(layer in perf for layer in layers)


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_every_cell_reports_setup_another_end_to_end_and_a_layer(cell):
    man = Manifest()
    e2e = [m["name"] for m in man.end_to_end(cell)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert man.per_layer(cell)


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_every_name_is_found_by_file(cell):
    man = Manifest()
    w = man.workload(cell)
    cfg = man.config(w["config"])
    assert cfg["model"]["name"] == w["config"]
    spec = man.cell(cell)
    assert man.mix(w["traffic"])["arrivals"] in ("poisson", "backlog")
    assert hasattr(man.kind(spec["kind"]), "run")
    for m in man.end_to_end(cell) + man.per_layer(cell):
        assert callable(man.reader(m["name"]))


@pytest.mark.parametrize("name,base", [("device_idle.chat", "device_idle"),
                                       ("device_idle.train", "device_idle"),
                                       ("prefill_ms_per_ktok.docs", "prefill_ms_per_ktok"),
                                       ("mfu.docs", "mfu.docs")])
def test_a_metric_reads_its_own_file_or_its_base_name(name, base):
    man = Manifest()
    assert man.reader(name).__module__ == f"metrics.{base}"


def test_config_files_are_distinct_and_under_paths():
    files = [c["file"] for c in MANIFEST["configs"]]
    assert len(set(files)) == len(files)
    for c in MANIFEST["configs"]:
        assert c["file"].startswith("bench/")
        cfg = json.loads((benchtest.ROOT / c["file"]).read_text())
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
        for key in c["reduced"]:
            assert key in cfg["published"]


def test_a_new_cell_is_files_and_entries(tmp_path):
    """A configuration, a mix and a cell added to a copy as new files and
    manifest entries run end to end, no file of the copy edited."""
    before = {p.relative_to(benchtest.BENCH): p.read_bytes()
              for p in benchtest.BENCH.rglob("*") if p.is_file() and "__pycache__" not in p.parts
              and not p.name.startswith("test_")}
    path = benchtest.tiny_checkout(tmp_path)
    after = {p: (tmp_path / "bench" / p).read_bytes() for p in before}
    assert after == before
    res = benchtest.run_cpu(path, seconds=1.0)
    assert res["correct"] and set(res["metrics"]) == {"ttft_p95_ms", "itl_p95_ms", "setup_s"}
