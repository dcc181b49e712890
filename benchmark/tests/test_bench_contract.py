"""BENCHMARK.json against the benchmark's contract, and the harness's
files found by name: what a later PR adds as new files, it edits no file
to reach."""

import ast
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "matten_tpu"}
QUANTITIES = ("train_crystals_per_s", "train_peak_mib", "setup_s")


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_names_and_units(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(bench["paths"]) <= 16 and all(PATH.match(p) and ".." not in p for p in bench["paths"])
    assert len(bench["command"]) <= 32 and all(_line(w) and not w.startswith("/") for w in bench["command"])
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
        names.append(c["name"])
    configs = {c["name"] for c in bench["configs"]}
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        names.append(w["name"])
    assert configs == {w["config"] for w in bench["workloads"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e and 1 <= len(e2e) <= 16
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        assert m["name"].split(".")[0] in QUANTITIES
    layers = {}
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and _line(m["layer"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert (BENCH / "metrics" / f"{m['name'].split('.')[0]}.py").is_file()
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert len(names) == len(set(names))
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_every_cell_reports_what_its_metrics_ask(bench):
    from benchmark.harness import reported

    cells = {w["name"]: w for w in bench["workloads"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert set(m.get("workloads", cells)) <= set(cells)
    for cell in cells.values():
        e2e = {m["name"] for m in reported(bench["end_to_end"], cell)}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = reported(bench["per_layer"], cell)
        assert layer and all(m["moves"] in e2e for m in layer)
        assert cell["chips"] == 1  # the harness drives one card


def test_config_files_hold_what_runs(bench):
    for c in bench["configs"]:
        config = json.loads((ROOT / c["file"]).read_text())
        assert config["name"] == c["name"]
        assert set(c["reduced"]) == set(config["reduced"]) <= set(config["assumed"])
        assert all(v is not None for v in config["limits"].values())


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(p.relative_to(BENCH) for p in BENCH.rglob("*.py")
                                        if "tests" not in p.parts), ids=str)
def test_no_module_imports_jax_or_the_jax_package(path):
    tops = {name.split(".")[0] for name in _imports(BENCH / path)}
    assert not tops & FORBIDDEN
    if path.parts[0] == "reference" or path.name in ("work.py", "weights.py", "traffic.py", "chrome_trace.py"):
        # the yardstick reads nothing of the program
        assert "matten_tpu_torch" not in tops


def test_run_without_a_card_prints_nothing_and_fails():
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "elasticity-train", "--seed", "1",
                           "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                          env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "", "HOME": str(ROOT)}, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_a_new_config_mix_and_metric_are_found_by_name(tmp_path, monkeypatch):
    from benchmark import harness

    copy = tmp_path / "benchmark"
    shutil.copytree(BENCH, copy, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in copy.rglob("*") if p.is_file()}
    config = json.loads((copy / "configs" / "matten-nmr-si.json").read_text())
    (copy / "configs" / "new-config.json").write_text(json.dumps(dict(config, name="new-config")))
    (copy / "traffic" / "new-mix.json").write_text(json.dumps({"atoms": [8, 14]}))
    (copy / "metrics" / "new_metric.py").write_text("def read(span):\n    return 42.0\n")
    monkeypatch.setattr(harness, "BENCH", copy)
    assert harness.load("configs", "new-config")["name"] == "new-config"
    assert harness.load("traffic", "new-mix")["atoms"] == [8, 14]
    # a metric's twins in cells of different rates share its reader
    assert harness.metric_reader("new_metric.train")(None) == harness.metric_reader("new_metric.nmr")(None) == 42.0
    assert all(p.read_bytes() == b for p, b in before.items())
