"""BENCHMARK.json resolves every name to its file and keeps to the
benchmark's format; nothing under perfbench/ imports JAX or the JAX
package (compared by whole top-level names: baspacho_tpu_torch is not
baspacho_tpu), and the reference imports nothing of the port; the run
command fails, and prints no result, without a card."""

import ast
import json
import os
import re
import subprocess
import sys

import pytest

from perfbench import harness

ROOT = harness.ROOT
BENCH = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "baspacho_tpu"}


def py_files(sub=""):
    top = os.path.join(harness.HERE, sub)
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def imported(path) -> set:
    """Top-level names of every module the file imports."""
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", None) == "import_module":
            arg = node.args[0]
            if isinstance(arg, ast.Constant):
                names.add(arg.value.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(py_files()))
def test_no_jax_imports(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(py_files("reference")))
def test_reference_imports_nothing_of_the_port(path):
    assert not imported(path) & (FORBIDDEN | {"baspacho_tpu_torch"})
    assert imported(path) <= {"__future__", "dataclasses", "typing",
                              "numpy", "torch"}


def test_a_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r); "
            "import perfbench.harness as h; "
            "assert not h.forbidden_modules(), h.forbidden_modules()"
            % ROOT)
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT)


def test_names_resolve():
    configs = {c["name"]: c for c in BENCH["configs"]}
    used = set()
    for w in BENCH["workloads"]:
        cfg = harness.load_json(os.path.join(ROOT,
                                             configs[w["config"]]["file"]))
        assert cfg["name"] == w["config"]
        assert os.path.exists(os.path.join(
            harness.HERE, "reference", cfg["generator"] + ".py"))
        assert set(cfg["reduced"]) == set(configs[w["config"]]["reduced"])
        traffic = harness.load_json(os.path.join(
            harness.HERE, "traffic", w["traffic"] + ".json"))
        harness.step_module(traffic["step"]).check(traffic)
        used.add(w["config"])
    assert used == set(configs)
    for m in BENCH["per_layer"]:
        assert callable(harness.reader(m["name"]))
        assert set(m.get("workloads", [])) <= {w["name"]
                                               for w in BENCH["workloads"]}


def test_format():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"][1].startswith(BENCH["paths"][0] + "/")
    assert 1 <= BENCH["run_seconds"] <= 51
    entries = BENCH["configs"] + BENCH["workloads"] + \
        BENCH["end_to_end"] + BENCH["per_layer"]
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for e in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
    for e in BENCH["end_to_end"]:
        assert 0.01 <= e["bound"] <= 0.25
        assert e["source"] in ("host_clock", "device_trace")
    e2e = {e["name"] for e in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
    for w in BENCH["workloads"]:
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_run_fails_without_a_card():
    if harness.torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         BENCH["workloads"][0]["name"], "--seed", "3000000000",
         "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert "{" not in p.stdout
    assert "no CUDA device" in p.stderr


def test_run_fails_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and the files under
    paths, the command fails and prints no result."""
    import shutil
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    for p in BENCH["paths"]:
        shutil.copytree(os.path.join(ROOT, p), tmp_path / p,
                        ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run(
        ["python3", *BENCH["command"][1:], "--workload",
         BENCH["workloads"][0]["name"], "--seed", "7", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, env=env, capture_output=True,
        text=True, timeout=300)
    assert p.returncode != 0
    assert "{" not in p.stdout
