"""The comparisons that decide `correct`.

Training (the `sweep` entry): the plain reference (`reference/tn.py`,
float64) follows the program's steps from the same state on the same rows,
in two stages:

- the start: set-up drives the cell's one training object from the
  benchmark's weights through its first steps with the window's own call;
  the reference follows them from those weights. Compared: each step's
  loss (`loss_gap`) and each leaf's norm of change over the steps
  (`change_gap`, `tn.leaf_change_gap`).
- the window's last unit: the reference follows its first steps from the
  parameters the program held when that unit began (the program's own
  state: nothing else reaches it), on all the rows. Compared: each leaf's
  norm of change (`last_change_gap`).

and the forward of the parameters the window ended with: the program's
predictions on every row against the reference's (`forward_gap`, max
|program - reference| over max |reference|).

Serving: every kept answer of the window against the reference's forward of
the same batch (`serve_gap`, the same measure).

`variants` gives the readings that set the limits: "control", the
reference computed in the cell's control numerics in the program's place,
and "half", the reference with half of each chunk's rows left out and the
mean taken over the rest.
"""
from __future__ import annotations

import sys
from typing import Callable, Dict, List, Optional, Sequence

import torch

from .reference import tn

Readings = Dict[str, Dict[str, float]]


def stage_readings(tag: str, p0: Dict[str, torch.Tensor], follow: Callable,
                   prog_losses: Optional[List[float]], prog_final: Dict[str, torch.Tensor],
                   control: str, half: torch.Tensor, variants: Sequence[str]) -> Readings:
    """One stage's readings, each variant's numbers named `<tag>loss_gap`
    and `<tag>change_gap`. `follow(numerics, keep)` runs the reference
    through the stage's steps from `p0` and returns (each step's loss, the
    cores after them); `keep` is None or per-row weights. Without the
    program's losses only the change is compared."""
    ref_losses, ref_final = follow(tn.Numerics(), None)
    p0 = {k: v.double() for k, v in p0.items()}

    def gaps(losses, final):
        out = {}
        if prog_losses is not None:
            out[tag + "loss_gap"] = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
        cg, still = tn.leaf_change_gap(p0, final, ref_final)
        if still:
            print(f"[check] {tag or 'start'}: leaves the reference leaves where they were:"
                  f" {still}", file=sys.stderr)
        out[tag + "change_gap"] = cg
        return out

    def variant(numerics="f64", keep=None):
        """A variant whose factorisation fails has failed: it reads inf."""
        try:
            return gaps(*follow(tn.Numerics(numerics), keep))
        except torch.linalg.LinAlgError as e:
            print(f"[check] the {numerics} variant failed: {e}", file=sys.stderr)
            names = ["loss_gap"] * (prog_losses is not None) + ["change_gap"]
            return {tag + k: float("inf") for k in names}

    out: Readings = {}
    for v in variants:
        if v == "program":
            out[v] = gaps(prog_losses, prog_final)
        elif v == "control":
            out[v] = variant(control)
        elif v == "half":
            out[v] = variant(keep=half)
        else:
            raise ValueError(f"unknown variant {v!r}")
    return out


def forward_readings(name: str, got: torch.Tensor, reference: Callable, control: str,
                     variants: Sequence[str]) -> Readings:
    """`reference(numerics)` is the reference's forward of the same inputs
    and parameters; the program's answers `got` and the control's are held
    to its float64 one. A half batch has no meaning here and reads
    nothing."""
    ref = reference(tn.Numerics())
    out: Readings = {}
    for v in variants:
        if v == "program":
            out[v] = {name: max_rel(got, ref)}
        elif v == "control":
            out[v] = {name: max_rel(reference(tn.Numerics(control)), ref)}
    return out


def merge(*parts: Readings) -> Readings:
    out: Readings = {}
    for p in parts:
        for v, nums in p.items():
            out.setdefault(v, {}).update(nums)
    return out


def half_rows(rows: int, chunk: int, device) -> torch.Tensor:
    """Weights of the fault: the first half of each chunk's rows at 2, the
    rest left out."""
    k = torch.zeros((rows,), dtype=torch.float64, device=device)
    for a in range(0, rows, chunk):
        m = min(chunk, rows - a)
        k[a:a + m // 2] = 2.0
    return k


def max_rel(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max |got - ref| over max |ref|; not a number (a diverged run) reads
    inf."""
    got, ref = got.double().to(ref.device), ref.double()
    if not bool(torch.isfinite(got).all()):
        return float("inf")
    return float((got - ref).abs().max() / ref.abs().max())
