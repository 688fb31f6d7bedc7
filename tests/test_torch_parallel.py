"""The port's 1-D data mesh (parallel/mesh.py, Sweeper.run(mesh=)) against
its single-process sweep and the JAX package's mesh sweep.

Each scenario is a counterpart of a 1-D case of tests/test_parallel.py
(line numbers below): the same params (made by the JAX package), the same
data (numpy seeds), the same config. The port sweeps it on 2 gloo ranks on
the CPU (`launch`, spawned once for the module: torch_parallel_cases.py),
and each result is held to the port's single-process sweep and to the JAX
package's sweep on the conftest's 8-device virtual CPU mesh at
test_parallel.py's tolerances (5e-3; 5e-2 in int8, whose per-rank
quantisation blocks differ). The ranks' params must be bit-equal.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import torch_parallel_cases as cases  # noqa: E402
from tensornetworksfork_tpu.core.engine import Network as JNetwork  # noqa: E402
from tensornetworksfork_tpu.core.sweep import Member as JMember  # noqa: E402
from tensornetworksfork_tpu.core.sweep import SweepConfig as JConfig  # noqa: E402
from tensornetworksfork_tpu.core.sweep import Sweeper as JSweeper  # noqa: E402
from tensornetworksfork_tpu.models import layers as jl  # noqa: E402
from tensornetworksfork_tpu.ops import bregman as jb  # noqa: E402
from tensornetworksfork_tpu.ops import compression as jc  # noqa: E402
from tensornetworksfork_tpu.parallel.mesh import make_mesh as jax_mesh  # noqa: E402
from tensornetworksfork_tpu_torch.core.sweep import Sweeper  # noqa: E402
from tensornetworksfork_tpu_torch.parallel import dryrun, mesh as pmesh  # noqa: E402

RANKS = 2
RTOL = 5e-3       # test_parallel.py's rtol = atol on params
RTOL_INT8 = 5e-2  # _params_close_int8
PRED_ITER = 1e-4  # the matrix-free cases' predictions (:88-92)
KERNEL_ENV = {"TNF_PACKED_SYRK_MIN_D": "1"}


def _tt_data(S=128, f=4, seed=0):
    """test_parallel.py _data: f-1 normal features and a bias column."""
    rng = np.random.default_rng(seed)
    X = np.concatenate([rng.standard_normal((S, f - 1)).astype(np.float32),
                        np.ones((S, 1), np.float32)], axis=1)
    return X, (X[:, 0] * X[:, 1] + X[:, 2]).reshape(S, 1).astype(np.float32)


def _conv_data(S, P, pp, C, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((S, P, pp)).astype(np.float32)
    return x, np.eye(C + 1, dtype=np.float32)[rng.integers(0, C + 1, S)]


def _jax_layer(kind, kw):
    cls = {"tt": jl.TensorTrainLayer, "conv": jl.TensorConvolutionTrainLayer,
           "compressed": jl.CompressedTensorTrainLayer}[kind]
    return cls(**kw)


def _spec(layers, x, y, cfg, loss="SquareBregFunction", loss_kw=None, env=None,
          use_kernels=False):
    params = [{k: np.asarray(v) for k, v in _jax_layer(kind, kw).params.items()}
              for kind, kw in layers]
    return dict(layers=layers, params=params, x=x, y=y, cfg=cfg, loss=loss,
                loss_kw=loss_kw or {}, env=env or {}, use_kernels=use_kernels)


def _specs():
    tt = ("tt", dict(num_carriages=2, bond_dim=4, input_features=4, output_shape=(1,), seed=3))
    X, y = _tt_data()
    specs = {
        # :31
        "sweep": _spec([tt], X, y, dict(num_swipes=2, method="ridge_cholesky", eps=1e-4,
                                        batch_size=32)),
        # :31 with 101 samples in chunks of 33: 2 ranks pad each chunk to 34
        # rows (1 padding row in all), the JAX mesh to 40
        "sweep, padded": _spec([tt], *_tt_data(S=101),
                               dict(num_swipes=2, method="ridge_cholesky", eps=1e-4,
                                    batch_size=33)),
    }
    # :54
    for method in ("cg", "minres"):
        specs[method] = _spec([tt], X, y, dict(num_swipes=1, method=method, eps=1e-1,
                                               batch_size=32, max_iter=40, tol=1e-8))
    # :103, the type-I sum
    rng = np.random.default_rng(11)
    Xs = np.concatenate([rng.standard_normal((64, 3)).astype(np.float32),
                         np.ones((64, 1), np.float32)], axis=1)
    specs["sum"] = _spec(
        [("tt", dict(num_carriages=1, bond_dim=1, input_features=4, output_shape=(1,), seed=0)),
         ("tt", dict(num_carriages=2, bond_dim=3, input_features=3, output_shape=(1,), seed=1))],
        Xs, (Xs[:, 0] * Xs[:, 1]).reshape(-1, 1).astype(np.float32),
        dict(num_swipes=2, eps=1e-3, batch_size=32))
    xe = dict(loss="XEBregman", loss_kw={"w": 1.0})
    # :173, the packed route forced at tiny D through the kernels' wrappers
    specs["packed kernels"] = _spec(
        [("conv", dict(num_carriages=2, bond_dim=3, num_patches=4, patch_pixels=5,
                       output_shape=(3,), convolution_bond=2, seed=0))],
        *_conv_data(32, 4, 5, 3, 4),
        dict(num_swipes=1, batch_size=16, method="ridge_cholesky", eps=0.5),
        env=KERNEL_ENV, use_kernels=True, **xe)
    # :250, an input-less member (60 rows over the ranks), alone and in a
    # type-I sum (chunks of 30: the rest and the member's forward cross the
    # ranks, 26 padding rows)
    rng = np.random.default_rng(3)
    Xd = np.concatenate([rng.standard_normal((60, 3)).astype(np.float32),
                         np.ones((60, 1), np.float32)], axis=1)
    blocks, _ = jc.train_compress(list(jc.DataCompression(Xd).non_compressed(2)), rank=16)
    comp = ("compressed", dict(data_blocks=[np.array(b) for b in blocks], bond_dim=4,
                               output_shape=(1,), seed=0))
    yd = (Xd[:, 0] * Xd[:, 1]).reshape(-1, 1).astype(np.float32)
    specs["input-less"] = _spec([comp], Xd, yd, dict(num_swipes=4, eps=1e-3),
                                use_kernels=True)
    specs["input-less in a sum"] = _spec(
        [comp, ("tt", dict(num_carriages=1, bond_dim=1, input_features=4,
                           output_shape=(1,), seed=1))],
        Xd, yd + 0.5 * Xd[:, 2:3], dict(num_swipes=1, eps=1e-3, batch_size=30))
    # :286 as the port's f32 tiled route (TNF_KMIX is TPU-only)
    specs["f32 tiled"] = _spec(
        [("conv", dict(num_carriages=2, bond_dim=3, num_patches=4, patch_pixels=5,
                       output_shape=(3,), convolution_bond=2, seed=1))],
        *_conv_data(32, 4, 5, 3, 9),
        dict(num_swipes=1, batch_size=16, method="ridge_cholesky", eps=0.5),
        env=KERNEL_ENV, use_kernels=True, **xe)
    # :327, int8
    specs["int8"] = _spec(
        [("conv", dict(num_carriages=3, bond_dim=4, num_patches=5, patch_pixels=3,
                       output_shape=(3,), convolution_bond=2, seed=1))],
        *_conv_data(32, 5, 3, 3, 10),
        dict(num_swipes=1, batch_size=16, method="ridge_cholesky", eps=0.5),
        env=dict(KERNEL_ENV, TNF_GRAM_DTYPE="int8"), use_kernels=True, **xe)
    # :362, the deferred own-out Gram (always on in the port)
    specs["own-out deferral"] = _spec(
        [("conv", dict(num_carriages=3, bond_dim=4, num_patches=5, patch_pixels=3,
                       output_shape=(3,), convolution_bond=2, seed=2))],
        *_conv_data(64, 5, 3, 3, 11),
        dict(num_swipes=2, batch_size=32, method="ridge_cholesky", eps=0.5),
        env={"TNF_OWNOUT_DEFER": "1"}, **xe)
    return specs


NAMES = ["sweep", "sweep, padded", "cg", "minres", "sum", "packed kernels", "input-less",
         "input-less in a sum", "f32 tiled", "int8", "own-out deferral"]
# JAX's own tests set these for the same cases (:286 TNF_KMIX)
JAX_ENV = {"f32 tiled": {"TNF_KMIX": "1"}}


@pytest.fixture(scope="module")
def specs():
    out = _specs()
    assert list(out) == NAMES
    return out


@pytest.fixture(scope="module")
def ranks(specs):
    """Every scenario on 2 ranks, spawned once for the module: each rank's
    results, in rank order."""
    return pmesh.launch(cases.rank_main, RANKS, specs, specs["sweep"], threads=1,
                        timeout=120, join_timeout=300)


def _jax_sweep(spec, env):
    """The JAX package's sweep of the spec on the 8-device CPU mesh: the
    params (numpy) and the predictions on x."""
    layers = [_jax_layer(kind, kw) for kind, kw in spec["layers"]]
    members = []
    for layer in layers:
        net = JNetwork(layer.topology, use_pallas=spec["use_kernels"])
        if not layer.topology.input_nodes:
            members.append(JMember(net, lambda x: {}))
        elif len(layers) > 1:
            members.append(JMember(net, jl._slice_adapter(net)))
        else:
            members.append(JMember(net))
    loss = getattr(jb, spec["loss"])(**spec["loss_kw"])
    x, y = jnp.asarray(spec["x"]), jnp.asarray(spec["y"])
    with cases.environ(**spec["env"], **env):
        out, ok = JSweeper(members, loss, JConfig(**spec["cfg"])).run(
            [dict(p) for p in spec["params"]], x, y, mesh=jax_mesh(8))
    assert ok
    pred = sum(np.asarray(m.net.forward(p, m.input_fn(x))) for m, p in zip(members, out))
    return [{k: np.asarray(v) for k, v in p.items()} for p in out], pred


def _close(got, want, rtol, what):
    for g, w in zip(got, want):
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=rtol, err_msg=f"{what}: {k}")


@pytest.mark.parametrize("name", NAMES)
def test_mesh_matches_single_and_jax(name, specs, ranks):
    """The port's 2-rank sweep against its single-process sweep and the JAX
    package's 8-device mesh sweep, params within 5e-3 (int8 5e-2); the
    matrix-free and input-less cases also by their predictions, as
    test_parallel.py holds them."""
    spec = specs[name]
    mesh_run = ranks[0][name]
    single = cases.sweep(spec)
    jax_params, jax_pred = _jax_sweep(spec, JAX_ENV.get(name, {}))
    assert mesh_run["ok"] and single["ok"]
    rtol = RTOL_INT8 if name == "int8" else RTOL
    if name.startswith("input-less"):
        # test_parallel.py:283: the fitted function, not the wandering params
        for want in (single["pred"], jax_pred):
            np.testing.assert_allclose(mesh_run["pred"], want, rtol=RTOL, atol=RTOL)
    else:
        _close(mesh_run["params"], single["params"], rtol, "port single process")
        _close(mesh_run["params"], jax_params, rtol, "JAX 8-device mesh")
    if name in ("cg", "minres"):
        for want in (single["pred"], jax_pred):
            np.testing.assert_allclose(mesh_run["pred"], want, rtol=PRED_ITER, atol=PRED_ITER)
        assert mesh_run["iters"] and mesh_run["iters"] == ranks[1][name]["iters"]
    if name in ("packed kernels", "f32 tiled"):
        # the Gram wrappers ran on the ranks (the N=2 layer's nodes take the
        # flat route, K10, as in the JAX package)
        assert sum(mesh_run["counts"].values()) > 0, mesh_run["counts"]
    if name == "int8":
        # N=3: the middle core takes the tiled int8 route (K1, K2, K3)
        assert all(mesh_run["counts"][k] > 0 for k in
                   ("retile_hmix", "quantize_tiled", "gram_pair_band_q")), mesh_run["counts"]
    if name == "own-out deferral":
        assert mesh_run["expansions"] > 0 and single["expansions"] > 0


@pytest.mark.parametrize("name", NAMES)
def test_mesh_params_bit_equal_across_ranks(name, ranks):
    """The solve runs replicated from bit-identical A and b: every rank ends
    with the same bits."""
    a, b = ranks[0][name], ranks[1][name]
    assert a["ok"] == b["ok"]
    for pa, pb in zip(a["params"], b["params"]):
        for k in pa:
            assert np.array_equal(pa[k], pb[k]), (name, k)


def test_timeout_on_one_ranks_clock_stops_both_ranks_alike(ranks):
    """Rank 0's clock decides the timeout: when it alone passes the limit
    (after the third update) both ranks stop at that update and report
    failure; when only rank 1's clock passes it, neither stops."""
    r0, r1 = (ranks[r]["timeout on rank 0's clock"] for r in (0, 1))
    assert not r0["ok"] and not r1["ok"]
    assert r0["updates"] == r1["updates"] == 3
    q0, q1 = (ranks[r]["timeout on rank 1's clock"] for r in (0, 1))
    assert q0["ok"] and q1["ok"] and q0["updates"] == q1["updates"] > 3


def test_collectives_were_counted(ranks):
    """Both ranks ran the same collectives (a rank that skipped one would
    have hung), all-reduces and broadcasts, and no all-to-all (the 1-D mesh
    has no model axis)."""
    s0, s1 = ranks[0]["stats"], ranks[1]["stats"]
    for kind in ("all_reduce", "broadcast"):
        assert s0[kind]["calls"] == s1[kind]["calls"] > 0
        assert s0[kind]["bytes"] == s1[kind]["bytes"] > 0
    assert s0["all_to_all"]["calls"] == 0


def test_two_d_mesh_and_model_axes_raise(specs, ranks):
    """The errors the 2-D data x model mesh keeps (it raised
    NotImplementedError until the port ran it): a ('data', 'model') shape
    that does not hold the world (2 x 2 over 2 ranks), an axis of a model
    label that does not split over the model ranks (5 patches over 2), in
    the input shards and in the network's sharding, and model axis labels
    without a model axis."""
    assert "does not hold the 2 ranks" in ranks[0]["2-D shape error"]
    assert ranks[0]["2-D shape error"] == ranks[1]["2-D shape error"]
    mesh2 = pmesh.Mesh(None, ("data", "model"), 4, 1, torch.device("cpu"), dims=(2, 2))
    assert mesh2.shape == {"data": 2, "model": 2}
    assert (mesh2.axis_rank("data"), mesh2.axis_rank("model")) == (0, 1)
    with pytest.raises(ValueError, match="does not split over 2 ranks"):
        pmesh.shard_chunked_inputs({"x": torch.zeros(1, 4, 5, 3)}, mesh2,
                                   {"x": ("patches", "patch_pixels")},
                                   model_labels=("patches",))
    with pytest.raises(ValueError, match="model labels"):
        pmesh.shard_chunked_inputs({}, pmesh.Mesh(None, "data", 2, 0, torch.device("cpu")),
                                   {}, model_labels=("patches",))
    layer = cases.tl.TensorConvolutionTrainLayer(2, 3, 5, 3, output_shape=(3,),
                                                 convolution_bond=2, device="cpu")
    with pytest.raises(ValueError, match="does not split over 2 model ranks"):
        layer.network.shard_model(mesh2, ("patches",))
    members, params, x, y = cases.build(specs["sweep"])
    sw = Sweeper(members, cases.tb.SquareBregFunction(), cases.SweepConfig(num_swipes=1))
    with pytest.raises(ValueError, match="need a mesh with a 'model' axis"):
        sw.run(params, x, y, model_axis_labels=("patches",))
    with pytest.raises(ValueError, match="mesh axes"):
        pmesh.make_mesh(axis=("model", "data"), device="cpu")


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="initialised default process group"):
        pmesh.make_mesh(device="cpu")


def test_dryrun_on_four_ranks(capsys):
    """The counterpart of __graft_entry__.dryrun_multichip (:98) on 4 ranks:
    the type-I sum and the packed kernel route under the data mesh, then on
    the 2 x 2 data x model mesh a training step, the packed kernel route and
    the r=16 MINRES swipe with its rows-conserved check, each with its OK
    line; the kernel routes called the Gram wrappers on every rank."""
    lines = dryrun.dryrun_multichip(4, device="cpu")
    assert len(lines) == 5
    assert all("OK on mesh {'data': 4}" in ln for ln in lines[:2])
    assert all("{'data': 2, 'model': 2}" in ln and " OK" in ln for ln in lines[2:])
    assert "rows 16/4 per rank conserved" in lines[4]
    assert capsys.readouterr().out.count("OK") == 5


def test_shard_chunked_takes_each_ranks_rows():
    """shard_chunked keeps rank k's contiguous block of dim 1 and leaves
    tensors of fewer dims whole; gather_chunked's zero-padded placement
    puts each shard back (a one-rank mesh needs no group)."""
    x = torch.arange(2 * 6 * 3).reshape(2, 6, 3)
    for rank in range(3):
        m = pmesh.Mesh(group=None, axis="data", size=3, rank=rank, device=torch.device("cpu"))
        got, w = pmesh.shard_chunked((x, torch.ones(5)), m)
        assert torch.equal(got, x[:, 2 * rank:2 * rank + 2]) and w.shape == (5,)
    with pytest.raises(ValueError, match="does not split"):
        pmesh.shard_chunked(x, pmesh.Mesh(None, "data", 4, 0, torch.device("cpu")))
