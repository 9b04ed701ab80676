"""CPU tests of the benchmark's files: BENCHMARK.json within its contract,
every cell's files found by name, a cell added by files alone, what the
command imports, and the command's refusal without a card.

Run from the repository root: ``python -m pytest vobench/tests -q``."""

from __future__ import annotations

import ast
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from vobench import harness

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "visual_odometry_tpu"}


def test_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16 and 1 <= len(BENCH["command"]) <= 32
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p and (REPO / p).is_dir()
    for word in BENCH["command"]:
        assert TEXT.match(word) and not word.startswith("/") and ".." not in word
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for group in ("configs", "workloads"):
        names = [x["name"] for x in BENCH[group]]
        assert len(names) == len(set(names))
    assert len({m["name"] for m in metrics}) == len(metrics)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith(BENCH["paths"][0] + "/") and (REPO / c["file"]).is_file()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] in (1, 4) and TEXT.match(w["why"])
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert TEXT.match(m["layer"]) and m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                 "higher")
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(workload):
    c = harness.cell(workload, REPO)
    assert c.limits
    if "generator" not in c.config:   # a tracking cell: the six numbers of compare.NUMBERS
        assert set(c.limits) == set(harness.compare.NUMBERS)
    assert c.entry_path.is_file()
    assert {m["name"] for m, _ in c.end_to_end} >= {"setup_s"}
    assert len(c.end_to_end) >= 2 and c.per_layer
    for _, path in c.end_to_end + c.per_layer:
        assert callable(harness.load_module(path).read)


def test_a_cell_added_as_files(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(REPO / "vobench", tmp_path / "vobench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    traffic = json.loads((REPO / "vobench/traffic/batch64_pool4.json").read_text())
    traffic.update(sequences_per_call=32, pool_calls=2)
    (tmp_path / "vobench/traffic/batch32_pool2.json").write_text(json.dumps(traffic))
    shutil.copy(REPO / "vobench/limits/ref128.fleet64.json",
                tmp_path / "vobench/limits/ref128.fleet32.json")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "ref128.fleet32", "config": "vo_ref128",
                               "traffic": "batch32_pool2", "chips": 1, "why": "a smaller fleet"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    c = harness.cell("ref128.fleet32", tmp_path)
    assert c.traffic["sequences_per_call"] == 32 and c.config["name"] == "vo_ref128"
    assert c.entry_path == tmp_path / "vobench/entries/run_sequences_batched.py"
    assert {m["name"] for m, _ in c.end_to_end} == {m["name"] for m in BENCH["end_to_end"]
                                                   if "workloads" not in m}


def _modules_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(sorted({m.split('.')[0] for m in sys.modules}))"],
                         cwd=REPO, capture_output=True, text=True, check=True)
    return set(ast.literal_eval(out.stdout.strip().splitlines()[-1]))


def test_the_command_loads_no_jax():
    code = ("import json\n"
            "from vobench import harness, run, calibrate\n"
            "for w in json.load(open('BENCHMARK.json'))['workloads']:\n"
            "    c = harness.cell(w['name'])\n"
            "    harness.load_module(c.entry_path)\n"
            "    [harness.load_module(p) for _, p in c.end_to_end + c.per_layer]\n")
    loaded = _modules_after(code)
    assert not loaded & FORBIDDEN
    assert "visual_odometry_tpu_torch" in loaded


def test_the_reference_imports_nothing_of_the_program():
    loaded = _modules_after("from vobench import compare, generator, peaks, workmodels\n"
                            "from vobench.reference import vo")
    assert not loaded & (FORBIDDEN | {"visual_odometry_tpu_torch"})
    for path in (REPO / "vobench/reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            top = {n.split(".")[0] for n in names}
            assert not top & (FORBIDDEN | {"visual_odometry_tpu_torch"})


def test_the_command_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    res = subprocess.run([sys.executable, *BENCH["command"][1:], "--workload", "ref128.single",
                          "--seed", "3000000001", "--seconds", "1", "--trace", "0"],
                         cwd=REPO, capture_output=True, text=True)
    assert res.returncode != 0
    assert not res.stdout.strip()
