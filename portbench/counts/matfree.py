"""FLOP and byte counts of the matrix-free sweep of a type-I sum of conv-TTs
(the `cifar_minres` cell), written out from the model's equations.

Member m of an N-member sum is a conv-TT of m carriages over its own
patches (the first member P patches of q pixels with the bias, the others
P - 1 of q - 1); carriage i holds A_i (r_i, k_i, p, r_i+1) and
C_i (b_i, q, b_i+1), bonds 1 at the ends, the C logits on A_1 (k_1 = C).
A node's Jacobian is applied through the member's environments:
L (s, c, r_i, b_i) left of its carriage (c = C past the first carriage,
else 1), R (s, r_i+1, b_i+1) right of it, and the carriage's other factors:
X·C_i (s, p, b_i, b_i+1) for a core, X and A_i for a conv block. Each
product below is one contraction of `reference/matfree_sum.py`, counted as
2 × the product of the sizes of its indices, whatever order or kernels the
program runs:

- J v of a core: v·R, ·(X·C), ·L; of a conv block: X·v, ·R, ·A, ·L;
- J^T u: the same steps in reverse (L·u first, the sum over rows last);
- H (J v): 2·s·C·C; a matvec is J v, H and J^T u over every row;
- the linearisation of an update: X·C for a core, then J v (the
  prediction) and J^T g (b); the loss terms are not counted;
- an environment step: X·C, then ·L and ·A (left) or ·R and ·A (right).

A product with an environment that does not exist (left of the first
carriage, right of the last) is no product and is not counted.

A swipe's work (`swipe_flops`): every member's forward once (the sum's
cached outputs at the run's start); per member and half-pass, two
column-monotone runs (the cores, then the conv blocks), each a far chain
of n - 1 steps and n - 1 near advances; each update's linearisation and
k + 2 matvecs (the residual, the scale probe and the program's own k
iterations; the masked iterations past convergence are waste and are not
counted); per member and half-pass, one J v of its last node (its cached
output).

A matvec's least time (`least_matvec_s`): the larger of its FLOPs over the
card's float32 peak (the matvec contracts in float32: the network's
precision, TF32 off) and its bytes over the HBM rate, each operand read
once and the result written once, in float32: L, R, H, the carriage's
factors (X·C, or X and A_i), v and J^T H J v. A solve's MINRES runs k + 1
of them (the residual and k iterations).
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple

# NVIDIA H100 SXM5 data sheet: float32 outside the tensor cores, and HBM3
F32_PEAK = 6.7e13
HBM_BYTES_PER_S = 3.35e12
F32_BYTES = 4


def members(cfg: dict) -> List[Tuple[int, int, int]]:
    """(carriages, patches, pixels) of each member, first to last."""
    c = cfg["model"]
    return [(m, c["patches"] if m == 1 else c["patches"] - 1,
             c["patch_pixels"] if m == 1 else c["patch_pixels"] - 1)
            for m in range(1, c["N"] + 1)]


def sizes(n: int, i: int, P: int, q: int, r: int, CB: int, C: int) -> Dict[str, int]:
    """The index sizes around carriage i of an n-carriage member; "L" and
    "Rt" say whether the left and right environments exist (the first and last
    carriages have none on their outer side)."""
    return {"r": 1 if i == 1 else r, "R": 1 if i == n else r,
            "b": 1 if i == 1 else CB, "B": 1 if i == n else CB,
            "k": C if i == 1 else 1, "c": 1 if i == 1 else C, "p": P, "q": q, "C": C,
            "L": i > 1, "Rt": i < n}


def _z(cfg: dict, m: int, name: str) -> Dict[str, int]:
    c = cfg["model"]
    n, P, q = members(cfg)[m]
    return sizes(n, int(name[1:]), P, q, c["r"], c["CB"], c["logits"])


def jv_flops(z: Dict[str, int], core: bool, S: int) -> int:
    r, R, b, B, k, c, p, q = (z[x] for x in "rRbBkcpq")
    if core:
        steps = r * k * p * R * B * z["Rt"] + r * k * p * b * B
    else:
        steps = p * q * b * B + p * b * B * R * z["Rt"] + p * b * R * r * k
    return 2 * S * (steps + c * r * b * k * z["L"])


def jtu_flops(z: Dict[str, int], core: bool, S: int) -> int:
    r, R, b, B, k, c, p, q = (z[x] for x in "rRbBkcpq")
    if core:
        steps = r * k * b * p * B + r * k * p * B * R * z["Rt"]
    else:
        steps = r * k * b * p * R + p * b * R * B * z["Rt"] + p * q * b * B
    return 2 * S * (c * r * b * k * z["L"] + steps)


def matvec_flops(cfg: dict, m: int, name: str, S: int) -> int:
    """J^T H J v of node `name` of member m (0-based) over S rows."""
    z, core = _z(cfg, m, name), name[0] == "A"
    return jv_flops(z, core, S) + 2 * S * z["C"] ** 2 + jtu_flops(z, core, S)


def matvec_bytes(cfg: dict, m: int, name: str, S: int) -> int:
    z = _z(cfg, m, name)
    r, R, b, B, k, c, p, q, C = (z[x] for x in "rRbBkcpqC")
    D = (r * k * p * R) if name[0] == "A" else (b * q * B)
    n = S * C * C + 2 * D + S * c * r * b * z["L"] + S * R * B * z["Rt"]
    n += S * p * b * B if name[0] == "A" else S * p * q + r * k * p * R
    return F32_BYTES * n


def linearise_flops(cfg: dict, m: int, name: str, S: int) -> int:
    z, core = _z(cfg, m, name), name[0] == "A"
    prep = 2 * S * z["p"] * z["q"] * z["b"] * z["B"] if core else 0
    return prep + jv_flops(z, core, S) + jtu_flops(z, core, S)


def env_step_flops(z: Dict[str, int], side: str, S: int) -> int:
    r, R, b, B, k, c, p, q = (z[x] for x in "rRbBkcpq")
    xc = p * q * b * B
    if side == "left":
        return 2 * S * (xc + c * r * b * p * B * z["L"] + c * r * p * B * k * R)
    return 2 * S * (xc + p * b * B * R * z["Rt"] + p * b * R * r)


def swipe_flops(cfg: dict, S: int, updates: Iterable[Tuple[int, str, int]]) -> float:
    """Algorithmic FLOPs of one swipe over S rows whose updates were
    (member, node, k) (module docstring)."""
    c = cfg["model"]
    total = 0
    for m, (n, P, q) in enumerate(members(cfg)):
        z = [sizes(n, i, P, q, c["r"], c["CB"], c["logits"]) for i in range(1, n + 1)]
        left = [env_step_flops(z[i - 1], "left", S) for i in range(1, n + 1)]
        right = [env_step_flops(z[i - 1], "right", S) for i in range(1, n + 1)]
        total += sum(left)                              # the cached forward
        total += 2 * 2 * (sum(left[:-1]) + sum(right[1:]))
        total += jv_flops(z[-1], False, S) + jv_flops(z[0], True, S)
    for m, name, k in updates:
        total += linearise_flops(cfg, m, name, S) + (k + 2) * matvec_flops(cfg, m, name, S)
    return float(total)


def least_matvec_s(cfg: dict, S: int, updates: Sequence[Tuple[int, str, int]]) -> float:
    """Least seconds of the solves' matvecs: k + 1 a solve."""
    total = 0.0
    for m, name, k in updates:
        one = max(matvec_flops(cfg, m, name, S) / F32_PEAK,
                  matvec_bytes(cfg, m, name, S) / HBM_BYTES_PER_S)
        total += (k + 1) * one
    return total
