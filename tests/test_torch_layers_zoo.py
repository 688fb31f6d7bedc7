"""Every layer builder of the port held against the JAX package's: the same
topology (node names, axis ids, sizes, columns, train order), and the same
forward on the same params and inputs.

The JAX package makes the params; they are carried across with
`utils.convert.params_from_numpy` (complex ones in their own dtype); inputs
come from a numpy seed. Forwards agree within rtol 1e-5 (f32 sums in
another order: the port plans its own contraction path). `cum_sum_operator`
is a numpy array in both packages and must be bit-equal. Also the
topology helpers `without_nodes` and `node_axis_tuple`, and the complex
init (real and imaginary parts drawn apart).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tensornetworksfork_tpu.models import layers as jl  # noqa: E402
from tensornetworksfork_tpu_torch.models import layers as tl  # noqa: E402
from tensornetworksfork_tpu_torch.utils.convert import params_from_numpy  # noqa: E402

S = 7
FWD_RTOL = 1e-5


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal((S,) + shape).astype(np.float32)


def _op(f=3, N=2):
    return dict(left=jl.cum_sum_operator(0, N, f),
                right=jl.cum_sum_operator(N - 1, N, f))


# name -> (builder name, args, kwargs, inputs); the kwargs hold for both
BUILDERS = {
    "tt_linear": ("TensorTrainLinearLayer", (3, 3, 5, 2),
                  dict(output_shape=(2,), seed=1), lambda: _x(1, 5)),
    "tt_linear_frozen_perturb": ("TensorTrainLinearLayer", (3, 3, 5, 2),
                                 dict(output_shape=(1,), train_linear=False,
                                      perturb=True, seed=2), lambda: _x(2, 5)),
    "cumsum": ("CumSumLayer", (3, 3, 4), dict(output_shape=(2,), seed=3),
               lambda: _x(3, 4)),
    "cumsum_perturb": ("CumSumLayer", (4, 3, 3), dict(perturb=True, seed=4),
                       lambda: _x(4, 3)),
    "cumsum_one_core": ("CumSumLayer", (1, 3, 4), dict(seed=5), lambda: _x(5, 4)),
    "cpd": ("CPDLayer", (3, 4, 3), dict(output_shape=(2,), seed=6),
            lambda: _x(6, 3)),
    "cpd_perturb": ("CPDLayer", (3, 4, 3), dict(perturb=True, seed=7),
                    lambda: _x(7, 3)),
    "cpd_one_factor": ("CPDLayer", (1, 4, 3), dict(seed=8), lambda: _x(8, 3)),
    "cpd_train": ("CPDTrainLayer", (4, 3, 3), dict(output_shape=(2,), seed=9),
                  lambda: _x(9, 3)),
    "operator": ("OperatorTTLayer", (jl.cum_sum_operator(1, 4, 3), 3, 3, 2),
                 dict(output_shape=(1,), seed=10, **_op()), lambda: _x(10, 3)),
    "operator_cut": ("OperatorTTLayer", (jl.cum_sum_operator(1, 4, 3), 3, 3, 3),
                     dict(output_shape=(2,), train_operator=True, seed=11),
                     lambda: _x(11, 3)),
    "operator_ring": ("OperatorTTLayer", (jl.cum_sum_operator(1, 4, 3), 3, 2, 3),
                      dict(output_shape=(1,), ring=True, seed=12),
                      lambda: _x(12, 3)),
    "split": ("TensorTrainSplitInputLayer", (2, 3),
              dict(input_shape=(2, 3), output_shape=(1,), axle_bond=2, seed=13),
              lambda: [_x(13, 2, 3), _x(14, 2, 3)]),
    "grid": ("TensorConvolutionGridTrainLayer", (2, 2, 3, 2, 2, 4, 5),
             dict(output_shape=(2,), convolution_bond=2, seed=15),
             lambda: _x(15, 4, 5)),
    "grid_no_cb": ("TensorConvolutionGridTrainLayer", (3, 2, 2, 2, 0, 4, 5),
                   dict(output_shape=(2,), seed=16), lambda: _x(16, 4, 5)),
    "conv_operator": ("TensorConvOperatorLayer",
                      (np.random.default_rng(17).standard_normal((5, 3)), 3, 3, 2,
                       4, 5),
                      dict(output_shape=(2,), convolution_bond=2, seed=17),
                      lambda: _x(17, 4, 5)),
    "conv_operator_no_cb": ("TensorConvOperatorLayer",
                            ([np.eye(5, 3), np.ones((5, 2))], 3, 3, 2, 4, 5),
                            dict(seed=18), lambda: _x(18, 4, 5)),
}


def build_pair(name, dtype=None):
    cls, args, kw, make_x = BUILDERS[name]
    jlayer = getattr(jl, cls)(*args, **kw)
    tlayer = getattr(tl, cls)(*args, **kw, device="cpu")
    return jlayer, tlayer, make_x()


def same_topology(jt, tt):
    assert [n.name for n in tt.nodes] == [n.name for n in jt.nodes]
    assert tt.node_axes == jt.node_axes
    assert tt.axis_size == jt.axis_size
    assert tt.columns == jt.columns
    assert tt.output_axes == jt.output_axes
    assert tt.train_nodes == jt.train_nodes
    assert tt.main_nodes == jt.main_nodes
    assert [n.cpd_mask for n in tt.nodes] == [n.cpd_mask for n in jt.nodes]


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_builder_forward_matches_jax(name):
    jlayer, tlayer, x = build_pair(name)
    same_topology(jlayer.topology, tlayer.topology)
    assert ({k: tuple(v.shape) for k, v in tlayer.params.items()}
            == {k: tuple(v.shape) for k, v in jlayer.params.items()})
    # the explicit inits (perturb cores, CPD diagonals) are the same numbers
    for spec in jlayer.topology.nodes:
        if spec.kind == "param" and spec.init is not None and not callable(spec.init):
            np.testing.assert_array_equal(
                tlayer.params[spec.name].numpy(),
                np.asarray(jlayer.params[spec.name]))
    for k, v in jlayer.network.consts.items():
        np.testing.assert_array_equal(tlayer.network.consts[k].numpy(), np.asarray(v))
    params = params_from_numpy({k: np.asarray(v) for k, v in jlayer.params.items()},
                               device="cpu")
    jx = [jnp.asarray(a) for a in x] if isinstance(x, list) else jnp.asarray(x)
    tx = [torch.tensor(a) for a in x] if isinstance(x, list) else torch.tensor(x)
    want = np.asarray(jlayer(jx))
    got = tlayer(tx, params=params).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=FWD_RTOL,
                               atol=FWD_RTOL * np.abs(want).max())


@pytest.mark.parametrize("n,N,f", [(0, 1, 3), (0, 3, 4), (1, 3, 4), (2, 3, 4),
                                   (5, 9, 65)])
def test_cum_sum_operator_bit_equal(n, N, f):
    a, b = tl.cum_sum_operator(n, N, f), jl.cum_sum_operator(n, N, f)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b)


def test_complex_tt_forward_and_init():
    """Complex64 forward against the JAX package on the same params; the
    port's own complex init has nonzero imaginary parts of unit total norm,
    and a non-complex dtype is refused."""
    args = (3, 3, 4)
    jlayer = jl.ComplexTensorTrainLayer(*args, output_shape=(2,), seed=0)
    tlayer = tl.ComplexTensorTrainLayer(*args, output_shape=(2,), seed=0,
                                        device="cpu")
    same_topology(jlayer.topology, tlayer.topology)
    for v in tlayer.params.values():
        assert v.dtype == torch.complex64
        assert float(v.imag.abs().max()) > 0
        assert abs(float(torch.linalg.vector_norm(v)) - 1.0) < 1e-5
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((S, 4)) + 1j * rng.standard_normal((S, 4))).astype(np.complex64)
    params = params_from_numpy({k: np.asarray(v) for k, v in jlayer.params.items()},
                               device="cpu", dtype=torch.complex64)
    want = np.asarray(jlayer(jnp.asarray(x)))
    got = tlayer(torch.tensor(x), params=params).numpy()
    np.testing.assert_allclose(got, want, rtol=FWD_RTOL,
                               atol=FWD_RTOL * np.abs(want).max())
    with pytest.raises(ValueError):
        tl.ComplexTensorTrainLayer(*args, dtype=torch.float32, device="cpu")


def test_explicit_complex_init_passes_through():
    """An explicit complex init keeps its dtype, as in the JAX package."""
    from tensornetworksfork_tpu_torch.core.topology import TopologyBuilder
    init = (np.arange(6) + 1j).reshape(2, 3).astype(np.complex128)
    b = TopologyBuilder()
    b.node("A", ("p", "o"), (2, 3), init=init)
    b.node("X", ("s", "p"), (None, 2), kind="input")
    b.connect("A", "p", "X")
    p = b.finalize(["X"], ["A"], output_labels=("s", "o")).init_params(0, torch.float32)
    assert p["A"].dtype == torch.complex128
    assert np.array_equal(p["A"].numpy(), init)


@pytest.mark.parametrize("name", ["cumsum", "operator_ring", "conv_operator"])
def test_without_nodes_matches_jax(name):
    """without_nodes drops the named nodes and their edges as the JAX
    package's does; node_axis_tuple is the node's axes."""
    jlayer, tlayer, _ = build_pair(name)
    drop = [n.name for n in jlayer.topology.nodes if n.name.startswith("X")]
    jsub = jlayer.topology.without_nodes(drop)
    tsub = tlayer.topology.without_nodes(drop)
    same_topology(jsub, tsub)
    assert tsub.input_nodes == jsub.input_nodes == ()
    for ni in range(len(tsub.nodes)):
        assert tsub.node_axis_tuple(ni) == jsub.node_axis_tuple(ni)
