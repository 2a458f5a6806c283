"""Cells at a size that a CPU test run holds: a configuration's widths cut
(DAG-ERC hidden 16, 2 layers, batch 4) and a dozen short dialogues.  A cell
here is any pair of a configuration and a traffic mix under ``perfbench/``,
listed in ``BENCHMARK.json`` or not."""

from __future__ import annotations

import copy
import os
import tempfile
import time

from perfbench.core import harness, manifest

TRAIN = ("dagerc-iemocap", "lognormal-120")


def cell(config: str, traffic: str):
    """(a benchmark holding the cell ``<config>.<traffic>``, its configuration, its mix), cut down."""
    bench = copy.deepcopy(manifest.benchmark())
    name = f"{config}.{traffic}"
    bench["workloads"].append({"name": name, "config": config, "traffic": traffic, "chips": 1, "why": "a test"})
    cfg = copy.deepcopy(manifest.config(config))
    mix = copy.deepcopy(manifest.mix(traffic))
    cfg["flags"] += ["--hidden_dim=16"]
    cfg["after_flags"].update({"gnn_layers": 2, "train.batch_size": 4})
    cfg["model"].update(hidden_dim=16, gnn_layers=2)
    mix["corpus"].update(count=12, utterances=200, max_len=30, min_len=4)
    return bench, name, cfg, mix


def run(pair, seed: int = 3000000019, seconds: float = 0.5, traced: bool = False):
    """One run of the cell on the CPU (no look for a card), its trainer's
    directories under a temporary root."""
    bench, name, cfg, mix = cell(*pair)
    os.environ["ERC_TPU_EXPROOT"] = tempfile.mkdtemp(prefix="perfbench-test-")
    return harness.run_cell(bench, name, seed, seconds, traced, "cpu", time.perf_counter(), cfg=cfg, mix=mix)
