"""Unified run configuration (port of tensornetworksfork_tpu/utils/config.py).

One dataclass for the tabular CLI, loadable from argparse flags
(`from_args`), from environment variables (`from_env`, the JAX package's
parsing: upper-cased field names, with an optional prefix) or an override
dict (`merge`), with the JAX package's key names for the fields the port's
readers read. `validation_split`, `CB`, `kernel_size` and `kernel_stride`
stay out until a reader of them is ported (no module of the port reads them
from a RunConfig; train_image reads its own environment). max_iter and tol are not
fields: nothing reads them from a RunConfig in either package (train_image
reads MAX_ITER from its environment, and the estimator leaves both at
SweepConfig's defaults). The port adds `device` ("cuda" by default; "cpu"
only when asked for, and no visible card raises), and writes its results
under `build/` by default.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Optional


@dataclasses.dataclass
class RunConfig:
    # data
    dataset: str = "synthetic"
    data_path: str = "data"
    task: str = "regression"          # regression | classification
    # model
    model_type: str = "tt"            # tt | tt_type1 | cpd | cpd_type1 | tnml | tt_batch | mlp | polynomial
    N: int = 3
    r: int = 8
    output_dim: int = 1
    linear_dim: Optional[int] = None
    constrict_bond: bool = False
    perturb: bool = False
    cum_sum: bool = False
    train_operator: bool = False
    # optimisation
    num_swipes: int = 5
    batch_size: int = 512
    method: str = "ridge_cholesky"
    swipe_method: str = "batch_same"  # tt_batch: batch_unique | batch_same | batch_block
    stream: Optional[str] = None      # tt_batch: "native" = the C++ prefetcher
    # numerics tier: reference | fast | fastest | None = respect TNF_* env
    precision: Optional[str] = None
    # solve numerics: refine = one f32 iterative-refinement pass;
    # solve_dtype="float64" = f64 solve for eps below the f32 floor (~1e-6)
    refine: bool = False
    solve_dtype: Optional[str] = None
    eps: float = 5.0
    eps_decay: Optional[float] = 0.25
    lr: float = 1.0
    # early stopping
    early_stopping: int = 10
    abs_err: float = 1e-4
    rel_err: float = 1e-3
    # misc
    seed: int = 42
    verbose: int = 1
    timeout: Optional[float] = None    # wall-clock abort of the sweep, s
    results_file: str = "build/tabular_results.csv"
    device: str = "cuda"               # "cpu" only when asked for

    @classmethod
    def field_names(cls):
        return [f.name for f in dataclasses.fields(cls)]

    @classmethod
    def from_env(cls, prefix: str = "") -> "RunConfig":
        """Env-var config: each field from the variable named by the prefix
        and the field's name, upper-cased (N, EPS, CONSTRICT_BOND, ...);
        absent variables keep the defaults. Booleans are "1", "true" or
        "yes" (any case); other fields parse as from_args parses them."""
        cfg = cls()
        for f in dataclasses.fields(cls):
            key = (prefix + f.name).upper()
            if key in os.environ:
                val, default = os.environ[key], getattr(cfg, f.name)
                setattr(cfg, f.name, val.lower() in ("1", "true", "yes")
                        if isinstance(default, bool) else _parser_for(default)(val))
        return cfg

    @classmethod
    def from_args(cls, argv=None) -> "RunConfig":
        p = argparse.ArgumentParser()
        cfg = cls()
        for f in dataclasses.fields(cls):
            default = getattr(cfg, f.name)
            if isinstance(default, bool):
                p.add_argument(f"--{f.name}", action="store_true",
                               default=default)
            else:
                p.add_argument(f"--{f.name}", default=default,
                               type=_parser_for(default))
        ns = p.parse_args(argv)
        for f in dataclasses.fields(cls):
            setattr(cfg, f.name, getattr(ns, f.name))
        return cfg

    def merge(self, overrides: dict) -> "RunConfig":
        """Override merge: known keys replace their fields, others are
        ignored."""
        cfg = dataclasses.replace(self)
        for k, v in overrides.items():
            if k in self.field_names():
                setattr(cfg, k, v)
        return cfg

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _parser_for(default):
    if default is None:
        # Optional fields: numbers parse as numbers, everything else stays a
        # string (Optional[str] knobs like precision="reference")
        def parse(s):
            if s in ("", "None", "none"):
                return None
            try:
                return float(s) if "." in s else int(s)
            except ValueError:
                return s
        return parse
    if isinstance(default, float):
        return float
    if isinstance(default, int):
        return int
    return str
