"""Result aggregation: seed-averaged tables, LaTeX output, frontier data
(port of tensornetworksfork_tpu/experiments/reporting.py).

The reference's reporting family: seed-averaged accuracy tables with a
minimum-seed-count filter (>= 3 seeds), LaTeX benchmark tables, the
accuracy-vs-parameter-count frontier and convergence trajectories. Every
function takes and returns pandas DataFrames, with the CSV layout of
utils.metrics.append_results_csv. pandas is imported inside each function,
so the module imports on a machine without it (the card's).
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np


def seed_averaged_table(df: "pd.DataFrame", group_cols: Sequence[str],
                        metric: str = "test_accuracy",
                        min_seeds: int = 3) -> "pd.DataFrame":
    """mean, std and count of `metric` per config, keeping configs with at
    least min_seeds replicates, best first."""
    g = df.groupby(list(group_cols))[metric]
    out = g.agg(["mean", "std", "count"]).reset_index()
    out = out[out["count"] >= min_seeds]
    out = out.rename(columns={"mean": f"{metric}_mean", "std": f"{metric}_std",
                              "count": "n_seeds"})
    return out.sort_values(f"{metric}_mean", ascending=False)


def to_latex_table(df: "pd.DataFrame", caption: str = "",
                   float_fmt: str = "%.2f") -> str:
    """A minimal LaTeX tabular of the frame."""
    cols = list(df.columns)
    lines = [r"\begin{table}[h]", r"\centering",
             r"\begin{tabular}{" + "l" * len(cols) + "}", r"\toprule",
             " & ".join(str(c).replace("_", r"\_") for c in cols) + r" \\",
             r"\midrule"]
    for _, row in df.iterrows():
        cells = []
        for c in cols:
            v = row[c]
            cells.append(float_fmt % v if isinstance(v, (float, np.floating))
                         else str(v).replace("_", r"\_"))
        lines.append(" & ".join(cells) + r" \\")
    lines += [r"\bottomrule", r"\end{tabular}"]
    if caption:
        lines.append(r"\caption{" + caption + "}")
    lines.append(r"\end{table}")
    return "\n".join(lines)


def pareto_frontier(df: "pd.DataFrame", x: str = "num_parameters",
                    y: str = "test_accuracy") -> "pd.DataFrame":
    """Rows not dominated in (fewer params, higher metric)."""
    import pandas as pd

    d = df.loc[df.groupby(x)[y].idxmax()].sort_values(x)
    best = -np.inf
    keep = []
    for _, row in d.iterrows():
        if row[y] > best:
            keep.append(row)
            best = row[y]
    return pd.DataFrame(keep)


def convergence_table(trajectory: List[dict]) -> "pd.DataFrame":
    """A fit trajectory (the module estimators' .trajectory) as a frame."""
    import pandas as pd

    return pd.DataFrame(trajectory)


def combine_result_files(paths: Sequence[str]) -> "pd.DataFrame":
    import pandas as pd

    return pd.concat([pd.read_csv(p) for p in paths], ignore_index=True)
