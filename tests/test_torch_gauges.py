"""The port's QR gauges (`core/gauges.py`) held against the JAX package's:
orthonormalize left / right / all on the same params give the same cores
(both sides run LAPACK's Householder QR on the CPU: the same factors
within rtol 1e-5), keep the forward within rtol 1e-5, and leave the gauged
cores orthonormal over their non-bond axes (within 1e-5). The wide-core
case, where the JAX package pads instead of shrinking the bond, is covered
by a core with fewer rows than bond columns. A sweep with
orthonormalize=True keeps each updated core orthonormal and matches the
JAX package's sweep (see tests/test_torch_zoo.py for TNML).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tensornetworksfork_tpu.core import gauges as jg  # noqa: E402
from tensornetworksfork_tpu.models.layers import TensorTrainLayer as JLayer  # noqa: E402
from tensornetworksfork_tpu_torch.core import gauges as tg  # noqa: E402
from tensornetworksfork_tpu_torch.models.layers import TensorTrainLayer as TLayer  # noqa: E402
from tensornetworksfork_tpu_torch.utils.convert import params_from_numpy  # noqa: E402

RTOL = 1e-5


def _pair(N=4, r=3, f=4, out=(2,), constrict=True, seed=0):
    jl = JLayer(N, r, f, output_shape=out, constrict_bond=constrict, seed=seed)
    tl = TLayer(N, r, f, output_shape=out, constrict_bond=constrict, seed=seed,
                device="cpu")
    p = params_from_numpy({k: np.asarray(v) for k, v in jl.params.items()},
                          device="cpu")
    x = np.random.default_rng(seed).standard_normal((9, f)).astype(np.float32)
    return jl, tl, p, x


def _same(tp, jp):
    for k in jp:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=RTOL,
                                   atol=RTOL * float(np.abs(np.asarray(jp[k])).max()),
                                   err_msg=k)


def _orthonormal(net, params, k, side):
    """Core k is orthonormal over its non-bond axes toward `side`: its
    bond-last matrix M has MᵀM = diag(I, 0) (zero columns only where the
    core was padded)."""
    t = net.topology
    nj = t.main_nodes[k + 1] if side == "left" else t.main_nodes[k - 1]
    pi, _ = tg._bond_axis(net, t.main_nodes[k], nj)
    core = params[t.nodes[t.main_nodes[k]].name]
    m = torch.movedim(core, pi, -1).reshape(-1, core.shape[pi]).double()
    G = (m.T @ m).numpy()
    rows = m.shape[0]
    want = np.diag([1.0] * min(rows, G.shape[0]) + [0.0] * max(0, G.shape[0] - rows))
    np.testing.assert_allclose(G, want, atol=1e-5)


@pytest.mark.parametrize("fn", ["orthonormalize_left", "orthonormalize_right"])
@pytest.mark.parametrize("k", [0, 1, 2, 3])
def test_single_gauge_matches_jax(fn, k):
    jl, tl, p, x = _pair()
    jout = getattr(jg, fn)(jl.network, jl.params, k)
    tout = getattr(tg, fn)(tl.network, p, k)
    _same(tout, jout)
    np.testing.assert_allclose(tl(torch.tensor(x), params=tout).numpy(),
                               np.asarray(jl(jnp.asarray(x))), rtol=RTOL, atol=1e-6)
    if fn == "orthonormalize_left" and k < 3:
        _orthonormal(tl.network, tout, k, "left")
    if fn == "orthonormalize_right" and k > 0:
        _orthonormal(tl.network, tout, k, "right")


@pytest.mark.parametrize("fn", ["orthonormalize_all_left", "orthonormalize_all_right"])
@pytest.mark.parametrize("constrict", [True, False])
def test_all_gauges_match_jax_and_keep_forward(fn, constrict):
    jl, tl, p, x = _pair(N=5, r=4, f=3, out=(1,), constrict=constrict, seed=1)
    jout = getattr(jg, fn)(jl.network, jl.params)
    tout = getattr(tg, fn)(tl.network, p)
    _same(tout, jout)
    before = tl(torch.tensor(x), params=p).numpy()
    after = tl(torch.tensor(x), params=tout).numpy()
    np.testing.assert_allclose(after, before, rtol=RTOL,
                               atol=RTOL * np.abs(before).max())
    ks = range(4) if fn.endswith("left") else range(1, 5)
    for k in ks:
        _orthonormal(tl.network, tout, k, "left" if fn.endswith("left") else "right")


def test_wide_core_pads_instead_of_shrinking():
    """constrict_bond=False and f=2 with r=5: the first core has 2 rows for a
    bond of 5. The JAX package pads Q with zero columns and R with zero rows
    (its test_layers.py wide-core case); so does the port: the bond keeps
    its size, the forward is kept and the core is orthonormal on its
    support."""
    jl, tl, p, x = _pair(N=3, r=5, f=2, out=(1,), constrict=False, seed=2)
    assert p["A1"].numel() // 5 < 5
    Q, R = tg._padded_qr(torch.movedim(p["A1"], -1, -1).reshape(-1, 5))
    assert Q.shape == (2, 5) and R.shape == (5, 5)
    assert not Q[:, 2:].any() and not R[2:].any()
    jout = jg.orthonormalize_left(jl.network, jl.params, 0)
    tout = tg.orthonormalize_left(tl.network, p, 0)
    assert tout["A1"].shape == p["A1"].shape and tout["A2"].shape == p["A2"].shape
    _same(tout, jout)
    np.testing.assert_allclose(tl(torch.tensor(x), params=tout).numpy(),
                               tl(torch.tensor(x), params=p).numpy(), rtol=RTOL,
                               atol=1e-6)
    _orthonormal(tl.network, tout, 0, "left")
