"""The port's 2-D data x model mesh (parallel/mesh.py make_mesh(axis=("data",
"model"), shape=(2, 2)); Sweeper.run(mesh=, model_axis_labels=("patches",)))
against its single-process sweep and the JAX package's 2-D mesh sweep.

Each scenario is a counterpart of a 2-D case of tests/test_parallel.py (line
numbers below) or of the dry run's 2-D lines: the same params (made by the
JAX package), the same data (numpy seeds), the same config. The port sweeps
it on 4 gloo ranks on the CPU as a 2 x 2 mesh, the patches sharded over
"model" (`launch`, spawned once for the module: torch_parallel_cases.py),
and each result is held to the port's single-process sweep and to the JAX
package's sweep on a 2 x 2 Mesh of the conftest's virtual CPU devices at
test_parallel.py's tolerances (5e-3; 5e-2 in int8). The ranks' params must
be bit-equal. A 2-D rank's Gram rows are those rank 2i + j holds on a 4-rank
1-D mesh, so the int8 sweep is also held to that mesh's, more tightly.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh as JMesh  # noqa: E402

import torch_parallel_cases as cases  # noqa: E402
from tensornetworksfork_tpu.core.engine import Network as JNetwork  # noqa: E402
from tensornetworksfork_tpu.core.sweep import SweepConfig as JConfig  # noqa: E402
from tensornetworksfork_tpu.core.sweep import Sweeper as JSweeper  # noqa: E402
from tensornetworksfork_tpu.models import layers as jl  # noqa: E402
from tensornetworksfork_tpu.ops import bregman as jb  # noqa: E402
from tensornetworksfork_tpu_torch.parallel import mesh as pmesh  # noqa: E402

RANKS = 4
RTOL = 5e-3       # test_parallel.py's rtol = atol on params
RTOL_INT8 = 5e-2  # _params_close_int8
# the 2-D int8 sweep against the 4-rank 1-D one: the same rows on each
# rank, J's f32 sums over the patches in another order (measured 1.6e-3 on
# the int8 case's params, where codes that flip move a 2,048-row block's
# scale; 3.5e-3 against one process)
RTOL_INT8_1D = 5e-3
PRED_ITER = 1e-4  # the matrix-free cases' predictions (:88-92)
KERNEL_ENV = {"TNF_PACKED_SYRK_MIN_D": "1"}
XE = dict(loss="XEBregman", loss_kw={"w": 1.0})


def _conv(N, r, P, pp, C, seed, S, data_seed, cfg, env=None, use_kernels=False):
    kw = dict(num_carriages=N, bond_dim=r, num_patches=P, patch_pixels=pp,
              output_shape=(C,), convolution_bond=2, seed=seed)
    params = {k: np.asarray(v) for k, v in jl.TensorConvolutionTrainLayer(**kw).params.items()}
    rng = np.random.default_rng(data_seed)
    x = rng.standard_normal((S, P, pp)).astype(np.float32)
    y = np.eye(C + 1, dtype=np.float32)[rng.integers(0, C + 1, S)]
    return dict(layers=[("conv", kw)], params=[params], x=x, y=y, cfg=cfg, env=env or {},
                use_kernels=use_kernels, **XE)


def _specs():
    dense = dict(num_swipes=1, eps=1.0, method="ridge_cholesky", batch_size=16)
    return {
        # :137, patches sharded over "model"
        "tp": _conv(2, 3, 8, 5, 3, 7, 32, 5, dense),
        # :210, N=3: the middle core on the packed kernel route
        "tp kernels": _conv(3, 3, 8, 5, 3, 7, 32, 5, dense, KERNEL_ENV, True),
        # :210 in the int8 Gram tier (K1, K2, K3)
        "tp int8": _conv(3, 3, 8, 5, 3, 7, 32, 5, dense,
                         dict(KERNEL_ENV, TNF_GRAM_DTYPE="int8"), True),
        # the matrix-free tier on :210's conv-TT, with :54's Krylov settings
        # at eps 1.0. (The dry run's r=16 MINRES step, 8 iterations on 16
        # samples, is no accuracy case: the JAX package's own single-device
        # and 2 x 2 runs of it differ by 1.9 on predictions of size 36, and at
        # eps 0.1 on this conv-TT by 0.14 of 98; at eps 1.0 by 7.6e-4 of 50.)
        "tp minres": _conv(3, 3, 8, 5, 3, 7, 32, 5,
                           dict(num_swipes=1, batch_size=16, method="minres", eps=1.0,
                                max_iter=40, tol=1e-8)),
    }


NAMES = ["tp", "tp kernels", "tp int8", "tp minres"]


@pytest.fixture(scope="module")
def specs():
    out = _specs()
    assert list(out) == NAMES
    return out


@pytest.fixture(scope="module")
def ranks(specs):
    """Every scenario on the 2 x 2 mesh, spawned once for the module (the
    int8 one also on the 4-rank data mesh; and a conv-TT of 5 patches,
    which do not split): each rank's results, in rank order."""
    unsplit = _conv(2, 3, 5, 5, 3, 7, 32, 5, specs["tp"]["cfg"])
    return pmesh.launch(cases.rank_main_2d, RANKS, specs, ("tp int8",), unsplit,
                        threads=1, timeout=120, join_timeout=300)


def _jax_sweep(spec):
    """The JAX package's sweep of the spec on a 2 x 2 (data, model) mesh of
    the conftest's CPU devices, the patches over "model": the params
    (numpy) and the predictions on x."""
    (kind, kw), = spec["layers"]
    layer = jl.TensorConvolutionTrainLayer(**kw)
    net = JNetwork(layer.topology, use_pallas=spec["use_kernels"])
    mesh = JMesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
    x, y = jnp.asarray(spec["x"]), jnp.asarray(spec["y"])
    with cases.environ(**spec["env"]):
        out, ok = JSweeper(net, getattr(jb, spec["loss"])(**spec["loss_kw"]),
                           JConfig(**spec["cfg"])).run(
            [dict(spec["params"][0])], x, y, mesh=mesh, model_axis_labels=("patches",))
    assert ok
    return ({k: np.asarray(v) for k, v in out[0].items()},
            np.asarray(net.forward(out[0], x)))


def _close(got, want, rtol, what):
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=rtol, err_msg=f"{what}: {k}")


@pytest.mark.parametrize("name", NAMES)
def test_mesh2d_matches_single_and_jax(name, specs, ranks):
    """The port's 2 x 2 sweep against its single-process sweep and the JAX
    package's 2 x 2 mesh sweep: params within 5e-3 (int8 5e-2); the MINRES
    case by its predictions, within 1e-4, and its iteration counts, equal on
    every rank; the kernel routes called the Gram wrappers on every rank."""
    spec = specs[name]
    run = ranks[0][name]
    single = cases.sweep(spec)
    jax_params, jax_pred = _jax_sweep(spec)
    assert run["ok"] and single["ok"]
    rtol = RTOL_INT8 if name == "tp int8" else RTOL
    if name == "tp minres":
        # Krylov iterates amplify reordered sums along near-null directions:
        # the fitted function is held, as test_parallel.py:88 holds its
        # matrix-free cases
        for want in (single["pred"], jax_pred):
            np.testing.assert_allclose(run["pred"], want, rtol=PRED_ITER, atol=PRED_ITER)
        assert run["iters"] and all(r[name]["iters"] == run["iters"] for r in ranks)
    else:
        _close(run["params"][0], single["params"][0], rtol, "port single process")
        _close(run["params"][0], jax_params, rtol, "JAX 2 x 2 mesh")
    if name == "tp kernels":
        # the middle core takes the tiled route (K1, K10's wrapper in f32)
        for r in ranks:
            assert r[name]["counts"]["retile_hmix"] > 0 and r[name]["counts"]["gram_pair"] > 0
    if name == "tp int8":
        for r in ranks:
            assert all(r[name]["counts"][k] > 0 for k in
                       ("retile_hmix", "quantize_tiled", "gram_pair_band_q")), r[name]["counts"]
        _close(run["params"][0], ranks[0]["tp int8, 1-D"]["params"][0], RTOL_INT8_1D,
               "4-rank 1-D mesh")


@pytest.mark.parametrize("name", NAMES)
def test_mesh2d_params_bit_equal_across_ranks(name, ranks):
    """The solve runs replicated from bit-identical A and b (dense) or
    Krylov vectors (MINRES): all 4 ranks end with the same bits."""
    for r in ranks[1:]:
        assert r[name]["ok"] == ranks[0][name]["ok"]
        for k, v in ranks[0][name]["params"][0].items():
            assert np.array_equal(v, r[name]["params"][0][k]), (name, k)


def test_mesh2d_collectives(ranks):
    """Every rank ran the same collectives (a rank that skipped one would
    have hung): all-reduces over the world, the model and the data groups,
    and the all-to-all that hands the Gram stage its rows."""
    s = [r["stats"] for r in ranks]
    for kind in ("all_reduce", "broadcast", "all_to_all"):
        assert all(x[kind]["calls"] == s[0][kind]["calls"] > 0 for x in s), kind
        assert all(x[kind]["bytes"] == s[0][kind]["bytes"] > 0 for x in s), kind


def test_mesh2d_refuses_an_axis_that_does_not_split(ranks):
    """5 patches over 2 model ranks: every rank raises before any
    collective."""
    for r in ranks:
        assert "does not split over 2 model ranks" in r["unsplit error"]


def test_rows_of_matches_the_one_d_mesh():
    """rows_of gives model rank j of data rank i the rows rank 2i + j of a
    4-rank data mesh holds, per run of a merged batch as well; the 2-D
    mesh's ranks sit row-major."""
    import torch
    x = torch.arange(3 * 16).reshape(3, 16)  # 3 chunks of 16 rows
    for rank in range(4):
        m2 = pmesh.Mesh(None, ("data", "model"), 4, rank, torch.device("cpu"), dims=(2, 2))
        m1 = pmesh.Mesh(None, "data", 4, rank, torch.device("cpu"))
        data_shard = pmesh.shard_chunked(x, m2)  # (3, 8): data rank i's rows
        merged = data_shard.reshape(-1)           # the chunks merged
        want = pmesh.shard_chunked(x, m1)         # (3, 4): rank 2i + j's rows
        assert torch.equal(pmesh.rows_of(merged, m2, groups=3), want.reshape(-1))
        assert torch.equal(pmesh.rows_of(data_shard[0], m2), want[0])
