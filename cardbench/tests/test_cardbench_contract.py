"""BENCHMARK.json and the benchmark's folder against the benchmark's rules:
names and units, every file found by name, no import of JAX or the JAX
package, no import of the port from the references, and a cell added by
data files alone."""

import ast
import json
import os
import re
import shutil

import pytest

from cardbench import harness

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def _spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _imports(path):
    """Top-level module names that a file imports (relative imports aside)."""
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                names.add(str(node.args[0].value).split(".")[0])
    return names


def _py_files(*parts):
    base = os.path.join(harness.HERE, *parts)
    for d, _, files in os.walk(base):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_jax_anywhere_and_no_port_in_the_references():
    for path in _py_files():
        found = _imports(path) & {"jax", "jaxlib", "flax", "nuzero_tpu"}
        assert not found, f"{path} imports {found}"
    for path in _py_files("reference"):
        assert "nuzero_tpu_torch" not in _imports(path), path


def test_the_forbidden_names_are_whole_names():
    assert "nuzero_tpu_torch".split(".")[0] not in harness.FORBIDDEN
    assert set(harness.FORBIDDEN) == {"jax", "jaxlib", "flax", "nuzero_tpu"}


@pytest.mark.parametrize("with_later", [False, True])
def test_benchmark_json_keeps_to_the_rules(with_later):
    """BENCHMARK.json alone, and with the entries of the cells kept for later
    (``later/<cell>.json``) added, as a PR that brings one back adds them."""
    spec = harness.spec_with_later() if with_later else _spec()
    if with_later:
        for name in os.listdir(os.path.join(harness.HERE, "later")):
            later = json.load(open(os.path.join(harness.HERE, "later", name)))
            assert set(later) == {"left_out", "workloads", "end_to_end", "per_layer"}
            assert [w["name"] + ".json" for w in later["workloads"]] == [name]
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert len(json.dumps(spec)) <= 64 * 1024
    assert spec["paths"] == ["cardbench"] and spec["command"][:2] == ["python3", "cardbench/run.py"]
    assert 1 <= spec["run_seconds"] <= 51 and isinstance(spec["run_seconds"], int)
    names = []
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert PATH.match(c["file"]) and c["file"].startswith("cardbench/")
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        names.append(c["name"])
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert w["config"] in names and NAME.match(w["traffic"])
        for part in (("traffic", w["traffic"] + ".json"), ("limits", w["name"] + ".json")):
            assert os.path.isfile(os.path.join(harness.HERE, *part)), part
        names.append(w["name"])
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in spec["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in spec["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert os.path.isfile(os.path.join(harness.HERE, "metrics", m["name"] + ".py"))
        for cell in m.get("workloads", []):
            mv = e2e[m["moves"]]
            assert "workloads" not in mv or cell in mv["workloads"]
        assert 1 <= len(m["layer"]) <= 200
        layers.setdefault(m["layer"], m["name"])
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert all(NAME.match(n) for n in names) and len(names) == len(set(names))
    for w in spec["workloads"]:
        # Every cell reports setup_s, another end-to-end metric and a per-layer one.
        own = [m for m in spec["end_to_end"] if "workloads" not in m or w["name"] in m["workloads"]]
        assert len(own) >= 2
        assert any(w["name"] in m.get("workloads", [w["name"]]) for m in spec["per_layer"])


def test_files_under_the_folder_have_plain_names():
    for d, _, files in os.walk(harness.HERE):
        for f in files:
            rel = os.path.relpath(os.path.join(d, f), ROOT)
            if "__pycache__" in rel:
                continue
            assert PATH.match(rel), rel


def test_a_cell_added_by_data_files_alone(tmp_path):
    """A copy of the benchmark gains a cell, a traffic mix and its limits as
    new files and one new workloads entry; nothing that was there changes,
    and the harness finds every piece by name."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.HERE, root / "cardbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = _spec()
    base = spec["workloads"][0]
    traffic = json.load(open(os.path.join(harness.HERE, "traffic", base["traffic"] + ".json")))
    traffic["games_per_phase"] = 64
    before = {p: open(p, "rb").read() for p in map(str, (root / "cardbench").rglob("*"))
              if os.path.isfile(p)}
    (root / "cardbench" / "traffic" / "dummy_mix.json").write_text(json.dumps(traffic))
    (root / "cardbench" / "limits" / "dummy.cell.json").write_text(
        (root / "cardbench" / "limits" / (base["name"] + ".json")).read_text())
    spec["workloads"].append({"name": "dummy.cell", "config": base["config"],
                              "traffic": "dummy_mix", "chips": 1, "why": "a test's cell"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = harness.find_cell("dummy.cell", root=str(root))
    assert cell.traffic["games_per_phase"] == 64 and cell.config_name == base["config"]
    for p, data in before.items():
        assert open(p, "rb").read() == data
    import importlib

    assert hasattr(importlib.import_module(f"cardbench.drivers.{cell.traffic['kind']}"), "run")


def test_run_without_a_card_prints_no_result(tmp_path):
    import subprocess
    import sys

    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "cardbench/run.py", "--workload",
                          _spec()["workloads"][0]["name"], "--seed", str(2**31 + 5),
                          "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_run_in_a_folder_without_the_port_fails(tmp_path):
    import subprocess
    import sys

    shutil.copytree(harness.HERE, tmp_path / "cardbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "cardbench/run.py", "--workload",
                          _spec()["workloads"][0]["name"], "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
