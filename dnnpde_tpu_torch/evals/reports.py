"""Results reporting: sweep rows → CSV, the counterpart of
``dnnpde_tpu/evals/reports.py``.

The CSV is written with the standard ``csv`` module in the JAX package's
format (pandas' ``to_csv(index=False)``): the given columns first, then the
rest in the order rows first name them; a missing value or NaN is an empty
field; a numeric column with a float or a missing value writes its integers
as floats ("8.0"), as pandas' float64 column does. pandas is imported only
by ``to_dataframe``.
"""

from __future__ import annotations

import csv
import dataclasses
import math
import numbers
from pathlib import Path
from typing import Any, Optional

RESULT_COLUMNS = [
    "Batch Size",
    "Dimensions",
    "Initial LR",
    "Fine Tuning LR",
    "Initial Iters",
    "Fine Tuning Iters",
    "Optimizer",
    "Mode",
    "Activation",
    "Correlation",
    "Mean Error",
    "Std Error",
    "RMSE",
    "Min Loss",
    "Exact Price",
    "Oracle SE",
    "Learned Price",
    "Relative Error",
    "Quality Flag",
    "Mean Spectral Radius",
    "Total Run Time",
]


def quality_row(
    learned: float,
    oracle: float,
    rel_threshold: float = 0.02,
    degenerate: bool = False,
) -> dict[str, Any]:
    """Run-quality columns shared by every executor: the relative error
    against the row's oracle and a flag, "ok" (rel ≤ threshold),
    "off_oracle" (trained but far from the oracle) or "degenerate"
    (caller-detected pinned or collapsed trajectory, or a non-finite
    error)."""
    rel = abs(learned - oracle) / max(abs(oracle), 1e-12)
    if degenerate or not math.isfinite(rel):
        flag = "degenerate"
    elif rel <= rel_threshold:
        flag = "ok"
    else:
        flag = "off_oracle"
    return {"Relative Error": rel, "Quality Flag": flag}


def _is_number(v) -> bool:
    return isinstance(v, numbers.Number) and not isinstance(v, bool)


def _field(v, as_float: bool) -> str:
    if v is None or (_is_number(v) and isinstance(v, numbers.Real) and math.isnan(v)):
        return ""
    if isinstance(v, numbers.Integral) and not isinstance(v, bool):
        return str(float(v)) if as_float else str(int(v))
    if isinstance(v, numbers.Real) and not isinstance(v, bool):
        return str(float(v))
    return str(v)


@dataclasses.dataclass
class ResultsReport:
    """Accumulates one row per sweep configuration; writes CSV."""

    columns: Optional[list[str]] = None

    def __post_init__(self):
        self.rows: list[dict[str, Any]] = []

    def add_row(self, **kwargs: Any) -> None:
        self.rows.append(kwargs)

    def column_order(self) -> list[str]:
        """``columns`` first, then every other key in the order rows first
        name it."""
        seen = list(self.columns or [])
        for row in self.rows:
            seen += [k for k in row if k not in seen]
        return seen

    def to_dataframe(self):
        import pandas as pd

        df = pd.DataFrame(self.rows)
        for c in self.columns or []:
            if c not in df.columns:
                df[c] = None
        return df[self.column_order()]

    def to_csv(self, path: str) -> str:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        cols = self.column_order()
        as_float = {}
        for c in cols:
            values = [row.get(c) for row in self.rows]
            present = [v for v in values if v is not None]
            numeric = bool(present) and all(_is_number(v) for v in present)
            as_float[c] = numeric and (len(present) < len(values) or any(
                not isinstance(v, numbers.Integral) for v in present))
        with open(path, "w", newline="") as f:
            writer = csv.writer(f, lineterminator="\n")
            writer.writerow(cols)
            for row in self.rows:
                writer.writerow([_field(row.get(c), as_float[c]) for c in cols])
        return path
