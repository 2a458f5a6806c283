"""Cross-run metric collection (reference: lumo/analyse/collect.py + the
``lumo sum`` CLI, cli/cli.py:41-89).

Port of ``erc_tpu.analyse``: walks the experiment root (``ERC_TPU_EXPROOT``,
the machine config's ``exproot`` or ``~/.erc_tpu``, the JAX package's own),
loads each test's metrics.json / board.jsonl, and produces comparable rows;
``python -m erc_tpu_torch.cli`` exposes it.  The port's runs are the
experiments named ``erc_tpu_torch.<TrainerClass>``.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

from erc_tpu_torch.core.experiment import exproot
from erc_tpu_torch.core.metrics_db import MetricBoard


def list_experiments(root: Optional[str] = None) -> List[str]:
    d = os.path.join(root or exproot(), "experiment")
    if not os.path.isdir(d):
        return []
    return sorted(os.listdir(d))


def list_tests(exp_name: str, root: Optional[str] = None) -> List[str]:
    d = os.path.join(root or exproot(), "experiment", exp_name)
    if not os.path.isdir(d):
        return []
    return sorted(os.listdir(d))


def collect_metrics(exp_name: Optional[str] = None, root: Optional[str] = None) -> List[Dict]:
    """One row per test: params hash/dataset + best metrics."""
    rows = []
    exps = [exp_name] if exp_name else list_experiments(root)
    for exp in exps:
        for test in list_tests(exp, root):
            tdir = os.path.join(root or exproot(), "experiment", exp, test)
            row: Dict = {"exp": exp, "test": test}
            mpath = os.path.join(tdir, "metrics.json")
            if os.path.exists(mpath):
                with open(mpath) as f:
                    row.update(
                        {k: v for k, v in json.load(f).items() if isinstance(v, (int, float))}
                    )
            ppath = os.path.join(tdir, "params.yaml")
            if os.path.exists(ppath):
                try:
                    import yaml

                    with open(ppath) as f:
                        params = yaml.safe_load(f)
                    for k in ("dataset", "modality", "seed"):
                        if isinstance(params, dict) and k in params:
                            row[k] = params[k]
                except Exception:
                    pass
            rows.append(row)
    return rows


def summarize_test(exp_name: str, test_name: str, root: Optional[str] = None) -> Dict:
    tdir = os.path.join(root or exproot(), "experiment", exp_name, test_name)
    out: Dict = {"exp": exp_name, "test": test_name}
    for key in ("initial", "final"):
        p = os.path.join(tdir, f"{key}.json")
        if os.path.exists(p):
            with open(p) as f:
                out[key] = json.load(f)
    mpath = os.path.join(tdir, "metrics.json")
    if os.path.exists(mpath):
        with open(mpath) as f:
            out["best_metrics"] = json.load(f)
    out["board"] = MetricBoard.load(os.path.join(tdir, "board.jsonl"))
    return out


def format_table(rows: List[Dict], columns: Optional[List[str]] = None) -> str:
    if not rows:
        return "(no runs found)"
    if columns is None:
        columns = ["exp", "test", "dataset", "modality", "seed", "f1", "acc", "wa", "maf1"]
        columns = [c for c in columns if any(c in r for r in rows)]
    widths = {c: max(len(c), *(len(str(r.get(c, ""))[:24]) for r in rows)) for c in columns}
    lines = ["  ".join(c.ljust(widths[c]) for c in columns)]
    for r in rows:
        lines.append(
            "  ".join(
                (f"{r[c]:.4f}" if isinstance(r.get(c), float) else str(r.get(c, "")))[
                    : max(widths[c], 8)
                ].ljust(widths[c])
                for c in columns
            )
        )
    return "\n".join(lines)


def load_tb_events(log_dir: str) -> Dict[str, List[tuple]]:
    """Parse tensorboard event files → {tag: [(step, value), ...]}.

    Reference: lumo/vis/parser_tb.py — the TB-event reader behind
    `lumo board`.  Runs with TensorBoardCallback's output; the jsonl
    metric board remains the primary (directly greppable) store."""
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator,
    )

    acc = EventAccumulator(log_dir)
    acc.Reload()
    out: Dict[str, List[tuple]] = {}
    for tag in acc.Tags().get("scalars", []):
        out[tag] = [(e.step, e.value) for e in acc.Scalars(tag)]
    return out


# -- pandas collection + condition query DSL (reference: lumo/analyse/
#    collect.py:5-14 + condition.py:30-180) --------------------------------


class Compare:
    """Deferred column predicate: ``C.f1 >= 0.6``, ``C.dataset == "x"``,
    ``C.seed.in_([1, 2])``; a bare ``C.name`` selects the column and
    ``~C.name`` drops it (condition.py:30-101 semantics)."""

    def __init__(self, name: Optional[str] = None):
        self.name = name
        self.op: Optional[str] = None
        self.value = None
        self.drop = False

    def __getattr__(self, item):
        if item.startswith("_"):
            raise AttributeError(item)
        return Compare(item)

    def __getitem__(self, item):
        return Compare(item)

    def __invert__(self):
        c = Compare(self.name)
        c.drop = True
        return c

    def _bin(self, op, other):
        c = Compare(self.name)
        c.op, c.value = op, other
        return c

    def __ge__(self, other):
        return self._bin(">=", other)

    def __le__(self, other):
        return self._bin("<=", other)

    def __gt__(self, other):
        return self._bin(">", other)

    def __lt__(self, other):
        return self._bin("<", other)

    def __eq__(self, other):  # noqa: D105
        return self._bin("==", other)

    def __ne__(self, other):
        return self._bin("!=", other)

    def in_(self, lis):
        return self._bin("in", set(lis))

    def not_in_(self, lis):
        return self._bin("notin", set(lis))

    def __repr__(self):
        return f"{self.name} {self.op} {self.value}"


C = Compare()


def collect_df(exp_name: Optional[str] = None, root: Optional[str] = None):
    """collect_metrics as a pandas DataFrame (collect.py:5-14)."""
    import pandas as pd

    return pd.DataFrame(collect_metrics(exp_name, root))


def filter_by_condition(df, *conditions: Compare):
    """Apply Compare predicates to a DataFrame; bare names select columns,
    inverted names drop them (condition.py:107-150)."""
    import operator as op_mod

    ops = {
        ">=": op_mod.ge, "<=": op_mod.le, ">": op_mod.gt, "<": op_mod.lt,
        "==": op_mod.eq, "!=": op_mod.ne,
        "in": lambda s, v: s.isin(v), "notin": lambda s, v: ~s.isin(v),
    }
    remains, drops = [], []
    for cond in conditions:
        if cond.op is None:
            (drops if cond.drop else remains).append(cond.name)
            continue
        if cond.value is None and cond.op in ("==", "!="):
            mask = df[cond.name].isna() if cond.op == "==" else ~df[cond.name].isna()
        else:
            mask = ops[cond.op](df[cond.name], cond.value)
        df = df[mask]
    if remains:
        df = df[remains]
    if drops:
        df = df.drop(columns=[d for d in drops if d in df.columns])
    return df
