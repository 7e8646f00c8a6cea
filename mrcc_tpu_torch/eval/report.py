"""The benchmark report (port of ``mrcc_tpu/eval/report.py``, after the
reference's ``app/test.py`` workbook): Avg / Min / Max / Med / Std / N per
metric, OVERALL and per position, written as ``.xlsx`` where pandas and
openpyxl are installed, else as ``.csv``, and always as ``.json`` with the
raw values."""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np


def _stats_row(values):
    v = np.asarray([x for x in values if x is not None and np.isfinite(x)],
                   np.float64)
    if len(v) == 0:
        return dict(Avg=None, Min=None, Max=None, Med=None, Std=None, N=0)
    return dict(Avg=float(v.mean()), Min=float(v.min()), Max=float(v.max()),
                Med=float(np.median(v)), Std=float(v.std()), N=int(len(v)))


def build_report_table(metrics: Dict[str, list]):
    """``{metric: [per-instance values]}`` -> ``{metric: stats}`` (None and
    non-finite values left out)."""
    return {name: _stats_row(vals) for name, vals in metrics.items()}


def _rows(table, cols):
    return [[name, *[table[name][c] for c in cols[1:]]] for name in table]


def _write_xlsx(path, table, pos_tables, cols):
    import openpyxl  # noqa: F401  (pandas' xlsx engine)
    import pandas as pd

    with pd.ExcelWriter(path) as xw:
        pd.DataFrame(_rows(table, cols), columns=cols).to_excel(
            xw, sheet_name="OVERALL", index=False)
        for p, tbl in pos_tables.items():
            pd.DataFrame(_rows(tbl, cols), columns=cols).to_excel(
                xw, sheet_name=str(p)[:31], index=False)


def _write_csv(path, table, pos_tables, cols):
    import csv

    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["SECTION", *cols])
        for section, tbl in [("OVERALL", table), *pos_tables.items()]:
            for r in _rows(tbl, cols):
                w.writerow([section] + ["" if x is None else x for x in r])


def write_report(metrics: Dict[str, list], out_path: str,
                 extra: Dict = None, position_metrics: Dict = None):
    """Write the report beside ``out_path`` (its extension replaced):
    ``.json`` always, then ``.xlsx`` or, without pandas and openpyxl,
    ``.csv``.  ``position_metrics``: ``{position: {metric: [values]}}``,
    one section or sheet each after OVERALL.  Returns ``(path written,
    OVERALL table)``."""
    table = build_report_table(metrics)
    pos_tables = {p: build_report_table(m)
                  for p, m in (position_metrics or {}).items()}
    base, _ = os.path.splitext(out_path)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(base + ".json", "w") as f:
        json.dump({"table": table, "extra": extra or {},
                   "positions": pos_tables,
                   "raw": {k: [None if v is None else float(v) for v in vals]
                           for k, vals in metrics.items()}}, f, indent=2)
    cols = ["Metric", "Avg", "Min", "Max", "Med", "Std", "N"]
    try:
        _write_xlsx(base + ".xlsx", table, pos_tables, cols)
        return base + ".xlsx", table
    except ImportError:
        _write_csv(base + ".csv", table, pos_tables, cols)
        return base + ".csv", table
