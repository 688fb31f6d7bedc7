"""Special functions in torch float64, elementwise on the tensor's device.

`kv(nu, x)`: the modified Bessel function of the second kind K_ν(x) of
real order ν (scipy.special.kv's function), which sklearn's Matern kernel
takes at any ν other than 0.5, 1.5, 2.5 and ∞. The scheme is the standard
`bessik` one (Temme 1975; Numerical Recipes §6.7):

- the order is split as ν = n + μ with n = round(ν) and |μ| <= 1/2;
- for x <= 2, Temme's series gives K_μ and K_μ+1; its coefficients need
  Γ(1 ± μ), which are host scalars since ν is one number for the whole
  tensor;
- for x > 2, Steed's continued fraction CF2 (Temme's form) gives them;
- the forward recurrence K_μ+k+1 = 2(μ + k)/x K_μ+k + K_μ+k-1, which is
  stable for K, brings the order up to ν.

Each series runs until every element's last term is below 1e-16 of its
sum; an element that has converged adds zeros from then on.
"""
from __future__ import annotations

import math

import torch

EPS = 1e-16
# scipy's kv (AMOS's zbesk) returns 0 below exp(-ELIM), its underflow
# limit for double precision: ELIM = 2.303 (1021 log10(2) - 3). (Its
# overflow test is an estimate that depends on ν: it returns inf from about
# 3e303 to 6e303 up, where this gives inf from float64's overflow.)
UNDERFLOW = math.exp(-2.303 * (1021 * math.log10(2.0) - 3.0))
# the x at which the evaluation moves from Temme's series to CF2
X_SWITCH = 2.0
# iterations between two host checks that every element has converged
_CHECK_EVERY = 8
_MAX_ITER = 10_000

# 1/Γ(z) = Σ_k A[k] z^(k+1) (Abramowitz & Stegun 6.1.34), so
# 1/Γ(1 + z) = Σ_k A[k] z^k
_RGAMMA = (1.0, 0.5772156649015329, -0.6558780715202538, -0.0420026350340952,
           0.1665386113822915, -0.0421977345555443, -0.0096219715278770,
           0.0072189432466630, -0.0011651675918591, -0.0002152416741149,
           0.0001280502823882, -0.0000201348547807, -0.0000012504934821,
           0.0000011330272320, -0.0000002056338417, 0.0000000061160950,
           0.0000000050020075, -0.0000000011812746, 0.0000000001043427,
           0.0000000000077823, -0.0000000000036968, 0.0000000000005100,
           -0.0000000000000206, -0.0000000000000054, 0.0000000000000014,
           0.0000000000000001)


def _temme_gammas(mu: float):
    """Temme's Γ terms at |μ| <= 1/2 (host scalars): gam1 = (1/Γ(1-μ) -
    1/Γ(1+μ)) / (2μ), gam2 = (1/Γ(1-μ) + 1/Γ(1+μ)) / 2, 1/Γ(1+μ), 1/Γ(1-μ).
    gam1 is the series' odd part divided by μ, so it has no cancellation at
    small μ."""
    gam1 = -sum(a * mu ** (k - 1) for k, a in enumerate(_RGAMMA) if k % 2 == 1)
    gampl = 1.0 / math.gamma(1.0 + mu)
    gammi = 1.0 / math.gamma(1.0 - mu)
    return gam1, 0.5 * (gammi + gampl), gampl, gammi


def _converged(done: torch.Tensor, i: int) -> bool:
    return i % _CHECK_EVERY == 0 and bool(done.all())


def _temme(mu: float, x: torch.Tensor):
    """K_μ(x) and K_μ+1(x) at 0 < x <= 2 by Temme's series."""
    gam1, gam2, gampl, gammi = _temme_gammas(mu)
    x2 = 0.5 * x
    pimu = math.pi * mu
    fact = 1.0 if abs(pimu) < EPS else pimu / math.sin(pimu)
    d = -torch.log(x2)
    e = mu * d
    fact2 = torch.where(e.abs() < EPS, 1.0, torch.sinh(e) / torch.where(e == 0, 1.0, e))
    ff = fact * (gam1 * torch.cosh(e) + gam2 * fact2 * d)
    total = ff
    e = torch.exp(e)
    p = 0.5 * e / gampl
    q = 0.5 / (e * gammi)
    c = torch.ones_like(x)
    dd = x2 * x2
    total1 = p
    mu2 = mu * mu
    for i in range(1, _MAX_ITER):
        ff = (i * ff + p + q) / (i * i - mu2)
        c = c * dd / i
        p = p / (i - mu)
        q = q / (i + mu)
        delta = c * ff
        total = total + delta
        total1 = total1 + c * (p - i * ff)
        # a converged element's c goes to 0, so its sums stay as they are
        done = delta.abs() < total.abs() * EPS
        c = torch.where(done, 0.0, c)
        if _converged(done, i):
            break
    return total, total1 * (2.0 / x)


def _steed(mu: float, x: torch.Tensor):
    """K_μ(x) and K_μ+1(x) at x > 2 by Steed's continued fraction CF2."""
    b = 2.0 * (1.0 + x)
    d = 1.0 / b
    h = delh = d
    q1 = torch.zeros_like(x)
    q2 = torch.ones_like(x)
    a1 = 0.25 - mu * mu
    q = torch.full_like(x, a1)
    c = a1
    a = -a1
    s = 1.0 + q * delh
    for i in range(2, _MAX_ITER):
        a -= 2 * (i - 1)
        c = -a * c / i
        qnew = (q1 - b * q2) / a
        q1, q2 = q2, qnew
        q = q + c * qnew
        b = b + 2.0
        d = 1.0 / (b + a * d)
        delh = (b * d - 1.0) * delh
        dels = q * delh
        h = h + delh
        s = s + dels
        # a converged element's delh goes to 0, so h and s stay as they are
        done = (dels / s).abs() < EPS
        delh = torch.where(done, 0.0, delh)
        if _converged(done, i):
            break
    rkmu = torch.sqrt(math.pi / (2.0 * x)) * torch.exp(-x) / s
    return rkmu, rkmu * (mu + x + 0.5 - a1 * h) / x


def kv(nu: float, x: torch.Tensor) -> torch.Tensor:
    """K_ν(x) elementwise, float64, on x's device, for a real order ν (a
    host number; K_-ν = K_ν). As scipy gives them, K_ν(0) is inf, K_ν(x)
    at x < 0 (or nan) is nan, and a value below UNDERFLOW is 0."""
    nu = abs(float(nu))
    x = torch.as_tensor(x, dtype=torch.float64)
    n = int(nu + 0.5)
    mu = nu - n
    flat = x.reshape(-1)
    k0 = torch.zeros_like(flat)
    k1 = torch.zeros_like(flat)
    for sel, method in (((flat > 0) & (flat <= X_SWITCH), _temme),
                        (flat > X_SWITCH, _steed)):
        idx = sel.nonzero().squeeze(1)
        if idx.numel():
            a, b = method(mu, flat[idx])
            k0[idx], k1[idx] = a, b
    xi2 = 2.0 / flat
    for i in range(1, n + 1):
        k0, k1 = k1, (mu + i) * xi2 * k1 + k0
    k0 = torch.where(k0 < UNDERFLOW, 0.0, k0)
    out = torch.where(flat > 0, k0, torch.where(flat == 0, math.inf, math.nan))
    return out.reshape(x.shape)
