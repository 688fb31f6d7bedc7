"""QR gauge fixing for tensor trains (port of tensornetworksfork_tpu/core/gauges.py).

Factor a main core with QR, keep the orthonormal factor and push the
triangular factor into the neighbouring main core: the forward map is
unchanged. Right-orthonormalisation takes a plain QR of the bond-last
matrix and pushes Rᵀ, the JAX package's gauge.

Shapes stay fixed: where a core is wide (fewer rows than bond columns),
the bond is not shrunk. Q gets zero columns and R zero rows instead
(`_padded_qr`), so the forward map stays exactly the same and the core is
orthonormal on its support (Q'ᵀQ' = diag(I, 0)). A neighbour's unridged
solve (method "exact", or eps 0) then sees a singular Gram and the sweep
reports failure; the ridge methods are unaffected.
"""
from __future__ import annotations

from typing import Dict

import torch

from .engine import Network


def _bond_axis(net: Network, ni: int, nj: int) -> tuple:
    """Positions of the one bond nodes ni and nj share, in each."""
    t = net.topology
    shared = (set(t.node_axes[ni]) & set(t.node_axes[nj])) - {t.sample_axis}
    if len(shared) != 1:
        raise ValueError(
            f"expected exactly one bond between {t.nodes[ni].name} and "
            f"{t.nodes[nj].name}, got {len(shared)}")
    a = shared.pop()
    return t.node_axes[ni].index(a), t.node_axes[nj].index(a)


def _padded_qr(mat: torch.Tensor) -> tuple:
    """Reduced QR with Q padded to mat's column count and R square: for
    rows < bond, Q gets zero columns and R zero rows, so Q @ R == mat."""
    rows, bond = mat.shape
    Q, R = torch.linalg.qr(mat, mode="reduced")
    if rows < bond:
        Q = torch.cat([Q, Q.new_zeros((rows, bond - rows))], dim=1)
        R = torch.cat([R, R.new_zeros((bond - rows, bond))], dim=0)
    return Q, R


def _qr_core(core: torch.Tensor, pi: int):
    """(Q reshaped as the core, R) of the core's bond-last matrix."""
    moved = torch.movedim(core, pi, -1)
    mat = moved.reshape(core.numel() // core.shape[pi], core.shape[pi])
    Q, R = _padded_qr(mat)
    return torch.movedim(Q.reshape(moved.shape), -1, pi), R


def orthonormalize_left(net: Network, params: Dict, k: int) -> Dict:
    """Left-orthonormalize main node k, pushing R into main node k+1."""
    t = net.topology
    if k >= len(t.main_nodes) - 1:
        return params
    ni, nj = t.main_nodes[k], t.main_nodes[k + 1]
    pi, pj = _bond_axis(net, ni, nj)
    name_i, name_j = t.nodes[ni].name, t.nodes[nj].name
    new_core, R = _qr_core(params[name_i], pi)
    nxt = torch.movedim(params[name_j], pj, 0)
    new_nxt = torch.movedim(torch.tensordot(R, nxt, dims=([1], [0])), 0, pj)
    return dict(params, **{name_i: new_core, name_j: new_nxt})


def orthonormalize_right(net: Network, params: Dict, k: int) -> Dict:
    """Right-orthonormalize main node k, pushing Rᵀ into main node k-1:
    core = Q R, so prev'[..., i] = sum_j prev[..., j] R[i, j] keeps the
    contraction."""
    t = net.topology
    if k <= 0:
        return params
    ni, nj = t.main_nodes[k], t.main_nodes[k - 1]
    pi, pj = _bond_axis(net, ni, nj)
    name_i, name_j = t.nodes[ni].name, t.nodes[nj].name
    new_core, R = _qr_core(params[name_i], pi)
    prv = torch.movedim(params[name_j], pj, -1)
    new_prv = torch.movedim(torch.tensordot(prv, R, dims=([-1], [1])), -1, pj)
    return dict(params, **{name_i: new_core, name_j: new_prv})


def orthonormalize_all_left(net: Network, params: Dict) -> Dict:
    """orthonormalize_left over all main nodes, left to right."""
    for k in range(len(net.topology.main_nodes)):
        params = orthonormalize_left(net, params, k)
    return params


def orthonormalize_all_right(net: Network, params: Dict) -> Dict:
    """orthonormalize_right over all main nodes, right to left."""
    for k in range(len(net.topology.main_nodes) - 1, -1, -1):
        params = orthonormalize_right(net, params, k)
    return params
