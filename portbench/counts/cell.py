"""The counts of a cell's unit of work, from its configuration's file."""
from __future__ import annotations

from . import flops, networks


def network(cfg: dict) -> networks.Net:
    c = cfg["model"]
    if cfg["family"] == "conv_tt":
        return networks.conv_tt(c["N"], c["r"], c["CB"], c["patches"], c["patch_pixels"],
                                c["logits"])
    if cfg["family"] == "tt":
        return networks.tt(c["N"], c["r"], cfg["data"]["features"] + 1)
    raise ValueError(f"no counts for the family {cfg['family']!r}")


def _args(cell):
    w = cell.workload
    return (network(cell.config), w["rows"], cell.config["training"]["chunk"], w["swipes"],
            cell.config["training"]["loss"] == "xe")


def unit_flops(cell) -> float:
    """Algorithmic FLOPs of one unit (a run of `swipes` swipes over all rows)."""
    return flops.run_flops(*_args(cell))["total"]


def unit_least_s(cell) -> float:
    """Least seconds of one unit's Gram and rhs work on the kernel routes."""
    return flops.run_least_s(*_args(cell), cell.workload["tier"])


def batch_flops(cell) -> float:
    """FLOPs of the forward over one served batch."""
    return flops.forward_flops(network(cell.config), cell.workload["batch"])
