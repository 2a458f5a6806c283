"""``BENCHMARK.json`` against the benchmark's contract, and the files it
names; and a configuration, a traffic mix and a per-layer metric added as
new files, found by name, with no edit to a file that is there."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from perfbench.core import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = manifest.benchmark()


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert (manifest.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert BENCH["command"] == ["python3", "perfbench/run.py"] and BENCH["paths"] == ["perfbench"]


def test_names_and_units():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and _line(w["why"]) and w["chips"] in (1, 4)


def test_configs():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and _line(c["source"]) and _line(c["why"])
        assert c["file"] == f"perfbench/configs/{c['name']}.json"
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        cfg = manifest.config(c["name"])
        assert cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]
        assert (manifest.HERE / "reference" / f"{c['name']}.py").exists()
        assert (manifest.HERE / "work" / f"{c['name']}.py").exists()


def test_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e
        for cell in m.get("workloads", cells):
            # every cell that reports the metric reports the end-to-end metric it moves
            assert cell in cells and cell in e2e[m["moves"]].get("workloads", [cell])
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert (manifest.HERE / "metrics" / f"{m['name']}.py").exists()


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_reports_enough(cell):
    e2e = [m["name"] for m in manifest.metrics_of(BENCH, cell, False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert manifest.metrics_of(BENCH, cell, True)
    w = manifest.cell(BENCH, cell)
    assert (manifest.HERE / "traffic" / f"{w['traffic']}.json").exists()


def test_layers_are_named_in_perf_md():
    perf = (manifest.ROOT / "PERF.md").read_text()
    for layer in {m["layer"] for m in BENCH["per_layer"]}:
        assert f"`{layer}`" in perf


def test_adding_files_adds_a_cell(tmp_path):
    """A configuration, a traffic mix and a per-layer metric, each a new file
    in a copy of the benchmark, reach a run of a new cell by name."""
    root = tmp_path / "checkout"
    shutil.copytree(manifest.HERE, root / "perfbench", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in (root / "perfbench").rglob("*") if p.is_file()}
    pb = root / "perfbench"
    for sub in ("reference", "work"):
        shutil.copy(pb / sub / "dagerc-iemocap.py", pb / sub / "dagerc-small.py")
    cfg = manifest.config("dagerc-iemocap")
    cfg["name"] = "dagerc-small"
    cfg["flags"] += ["--hidden_dim=16"]
    cfg["after_flags"].update({"gnn_layers": 2, "train.batch_size": 4})
    cfg["model"].update(hidden_dim=16, gnn_layers=2)
    (pb / "configs" / "dagerc-small.json").write_text(json.dumps(cfg))
    mix = manifest.mix("lognormal-120")
    mix["corpus"].update(count=12, utterances=200, max_len=30, min_len=4)
    (pb / "traffic" / "short-train.json").write_text(json.dumps(mix))
    (pb / "metrics" / "steps_per_epoch.train.py").write_text(
        "def read(r):\n    return r.window['steps'] / max(1, r.window['dialogues'])\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "dagerc-small", "source": "a copy", "file": "perfbench/configs/dagerc-small.json",
                             "reduced": ["dropout"], "why": "a test"})
    bench["workloads"].append({"name": "dagerc-small.short", "config": "dagerc-small", "traffic": "short-train",
                               "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_dia_per_s":
            m["workloads"].append("dagerc-small.short")
    bench["per_layer"].append({"name": "steps_per_epoch.train", "unit": "steps", "better": "higher",
                               "source": "host_clock", "layer": "loader", "moves": "train_dia_per_s",
                               "workloads": ["dagerc-small.short"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    for p, data in before.items():
        assert p.read_bytes() == data  # nothing that was there changed
    code = (f"import sys, time, os, tempfile; sys.path.insert(0, {str(root)!r}); sys.path.append({str(manifest.ROOT)!r})\n"
            "os.environ['ERC_TPU_EXPROOT'] = tempfile.mkdtemp()\n"
            "from perfbench.core import harness, manifest\n"
            f"b = manifest.benchmark(manifest.ROOT)\n"
            "res, _ = harness.run_cell(b, 'dagerc-small.short', 7, 0.5, True, 'cpu', time.perf_counter())\n"
            "print(sorted(res['metrics']), res['correct'])\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600,
                         env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert out.returncode == 0, out.stderr[-3000:]
    last = out.stdout.strip().splitlines()[-1]
    assert "steps_per_epoch.train" in last and last.endswith("True")
