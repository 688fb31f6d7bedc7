"""Numerics tiers (port of tensornetworksfork_tpu/utils/precision.py).

Estimators take `precision="reference"|"fast"|"fastest"` and wrap fit and
predict in `numerics_tier`, which sets the engine's env knobs for the
duration and restores the ambient values after:

- "reference": f32 Gram operands, every contraction in full f32;
- "fast": bf16 Gram operands and the bf16 aux tier;
- "fastest": int8 Gram operands and the bf16 aux tier.

The bf16 aux tier (TNF_AUX_PRECISION=default) rounds the operands of the
environment chains, Jacobian builds, predictions and rhs products to bf16
and sums in f32 (core/engine.py `Network.aux_precision`).
"""
from __future__ import annotations

import contextlib
import os
from typing import Dict, Iterator, Optional

TIERS: Dict[str, Dict[str, str]] = {
    "reference": {"TNF_GRAM_DTYPE": "f32", "TNF_AUX_PRECISION": "highest"},
    "fast": {"TNF_GRAM_DTYPE": "bf16", "TNF_AUX_PRECISION": "default"},
    "fastest": {"TNF_GRAM_DTYPE": "int8", "TNF_AUX_PRECISION": "default"},
}


def validate_tier(tier: Optional[str]) -> Optional[str]:
    if tier is None or tier == "":
        return None
    t = str(tier).lower()
    if t not in TIERS:
        raise ValueError(f"precision must be one of {sorted(TIERS)} or "
                         f"None (respect TNF_* env), got {tier!r}")
    return t


@contextlib.contextmanager
def numerics_tier(tier: Optional[str]) -> Iterator[None]:
    """Scope the engine's numerics env knobs to `tier` (no-op for None).
    Re-entrant and exception-safe: ambient values, absence included, are
    restored on exit."""
    t = validate_tier(tier)
    if t is None:
        yield
        return
    saved = {k: os.environ.get(k) for k in TIERS[t]}
    os.environ.update(TIERS[t])
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
