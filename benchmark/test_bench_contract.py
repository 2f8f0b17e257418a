"""BENCHMARK.json against the benchmark's contract, the files the harness
finds by name, and the import rules of benchmark/ (CPU)."""

import ast
import json
import os
import re

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"]
    assert b["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= b["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_units_and_text():
    b = bench()
    names = []
    for group, keys in (("configs", {"name", "source", "file", "reduced",
                                     "why"}),
                        ("workloads", {"name", "config", "traffic", "chips",
                                       "why"}),
                        ("end_to_end", {"name", "unit", "better", "bound",
                                        "source"}),
                        ("per_layer", {"name", "unit", "better", "source",
                                       "layer", "moves"})):
        for entry in b[group]:
            assert set(entry) - {"workloads"} == keys, entry
            assert NAME.match(entry["name"]), entry["name"]
            names.append((group, entry["name"]))
            for k in ("why", "layer") + (("source",) if group == "configs"
                                         else ()):
                if k in entry:
                    assert TEXT.match(entry[k]), (k, entry[k])
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
    for entry in b["workloads"]:
        assert NAME.match(entry["config"]) and NAME.match(entry["traffic"])
        assert entry["chips"] in (1, 4)
    for entry in b["configs"]:
        assert all(NAME.match(k) for k in entry["reduced"])
    metric_names = [n for g, n in names if g in ("end_to_end", "per_layer")]
    assert len(set(metric_names)) == len(metric_names)
    for g in ("configs", "workloads"):
        ns = [n for gg, n in names if gg == g]
        assert len(set(ns)) == len(ns)
    for word in b["command"]:
        assert TEXT.match(word) and not word.startswith("/")


def test_metrics_and_bounds():
    b = bench()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert set(m.get("workloads", cells)) <= cells
    for cell in cells:
        assert any(cell in m.get("workloads", cells) for m in b["per_layer"])


def test_files_found_by_name():
    """Every cell's workload, configuration and metric files exist where
    the harness looks for them, and agree with BENCHMARK.json."""
    b = bench()
    configs = {c["name"]: c for c in b["configs"]}
    for c in configs.values():
        path = os.path.join(ROOT, c["file"])
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        with open(path) as f:
            spec = json.load(f)
        assert spec["reduced"] == c["reduced"]
        assert spec["source"] == c["source"]
        assert os.path.exists(os.path.join(HERE, "configs",
                                           f"{c['name']}.py"))
    for w in b["workloads"]:
        assert w["traffic"] == w["name"]
        with open(os.path.join(HERE, "workloads", f"{w['name']}.json")) as f:
            wl = json.load(f)
        assert wl["config"] == w["config"] in configs
        assert wl["why"] == w["why"]
        compared = set(wl["limits"]["recon_mae_max"])
        assert compared and compared <= {str(q) for q in wl["qps"]}
    used = {w["config"] for w in b["workloads"]}
    assert used == set(configs)
    from benchmark import run
    for m in b["per_layer"]:
        mod = run.load_module(os.path.join(HERE, "metrics",
                                           f"{m['name']}.py"), "m")
        assert (mod.LAYER, mod.MOVES, mod.UNIT) == (m["layer"], m["moves"],
                                                    m["unit"])


def imports_of(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module)
    return out


def py_files(top):
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


@pytest.mark.parametrize("forbidden", ["jax", "jaxlib", "flax", "dcvc_tpu"])
def test_no_jax_import(forbidden):
    """Top-level names compared whole: dcvc_tpu_torch is not dcvc_tpu."""
    for path in py_files(HERE):
        for mod in imports_of(path):
            assert mod.split(".")[0] != forbidden, (path, mod)


def test_reference_imports_nothing_of_the_program():
    for path in py_files(os.path.join(HERE, "reference")):
        for mod in imports_of(path):
            assert mod.split(".")[0] not in ("dcvc_tpu_torch", "dcvc_tpu",
                                             "jax"), (path, mod)


def test_forbidden_modules_compares_whole_names(monkeypatch):
    import sys
    from benchmark import run
    monkeypatch.setitem(sys.modules, "dcvc_tpu_torch_fake", object())
    assert "dcvc_tpu_torch_fake" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "dcvc_tpu.fake", object())
    assert "dcvc_tpu.fake" in run.forbidden_modules()
