"""Plots from result CSVs (port of tensornetworksfork_tpu/experiments/plots.py).

The reference's plotting family: convergence curves (val metric against
epoch or time), accuracy against parameter count with the pareto front, and
seed-aggregated bars. matplotlib (Agg) and pandas are imported inside the
functions, so the module imports on a machine without them (the card's).
"""
from __future__ import annotations

from typing import Optional, Sequence

from .reporting import pareto_frontier, seed_averaged_table


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def convergence_plot(trajectories, labels: Optional[Sequence[str]] = None,
                     metric: str = "val_rmse", x: str = "epoch",
                     path: Optional[str] = None):
    """trajectories: fit-trajectory lists or DataFrames, one curve each."""
    import pandas as pd

    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 4))
    for i, traj in enumerate(trajectories):
        df = pd.DataFrame(traj)
        ax.plot(df[x], df[metric], label=labels[i] if labels else f"run {i}")
    ax.set_xlabel(x)
    ax.set_ylabel(metric)
    ax.set_yscale("log")
    ax.legend()
    if path:
        fig.savefig(path, bbox_inches="tight")
        plt.close(fig)
    return fig


def frontier_plot(df, x: str = "num_parameters", y: str = "test_accuracy",
                  group: Optional[str] = None, path: Optional[str] = None):
    """Accuracy-vs-params scatter with the pareto front drawn over it."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 4))
    if group and group in df.columns:
        for key, sub in df.groupby(group):
            ax.scatter(sub[x], sub[y], label=str(key), alpha=0.6, s=18)
        ax.legend()
    else:
        ax.scatter(df[x], df[y], alpha=0.6, s=18)
    front = pareto_frontier(df, x, y)
    ax.plot(front[x], front[y], "k--", lw=1.5, label="pareto front")
    ax.set_xscale("log")
    ax.set_xlabel(x)
    ax.set_ylabel(y)
    if path:
        fig.savefig(path, bbox_inches="tight")
        plt.close(fig)
    return fig


def seed_table_plot(df, group_cols: Sequence[str], metric: str = "test_accuracy",
                    min_seeds: int = 3, path: Optional[str] = None):
    """Bars of seed-averaged results with std error bars."""
    plt = _plt()
    tab = seed_averaged_table(df, group_cols, metric, min_seeds)
    labels = [" ".join(f"{c}={row[c]}" for c in group_cols) for _, row in tab.iterrows()]
    fig, ax = plt.subplots(figsize=(max(6, len(tab) * 0.8), 4))
    ax.bar(range(len(tab)), tab[f"{metric}_mean"],
           yerr=tab[f"{metric}_std"].fillna(0.0), capsize=3)
    ax.set_xticks(range(len(tab)))
    ax.set_xticklabels(labels, rotation=45, ha="right", fontsize=8)
    ax.set_ylabel(metric)
    if path:
        fig.savefig(path, bbox_inches="tight")
        plt.close(fig)
    return fig
