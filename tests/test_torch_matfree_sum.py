"""The matrix-free sweep of a type-I sum of conv-TTs (the CIFAR_minres
configuration at a small size) against the plain float64 reference
`portbench/reference/matfree_sum.py`, on the CPU: one MINRES swipe of the
port's `Sweeper` with the reference run for each update's own iteration
count k; the matvec counter `Sweeper.krylov_matvecs`; the spans
`tnf.krylov.matvec` and `tnf.krylov.check`; and the matvec FLOP count of
`portbench/counts/matfree.py` against a count by hand.
"""
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils.flop_counter import FlopCounterMode

from portbench import cifar, data
from portbench.counts import matfree
from portbench.reference import matfree_sum as mf
from portbench.reference.tn import Numerics
from tensornetworksfork_tpu_torch.core.engine import Network
from tensornetworksfork_tpu_torch.core.sweep import Member, SweepConfig, Sweeper
from tensornetworksfork_tpu_torch.experiments import train_image
from tensornetworksfork_tpu_torch.ops.bregman import XEBregman

# members of 1 and 2 carriages, r=4, CB=2, 3 x 16 x 16 images cut by kernel
# 8: 5 x 193 patches with the bias; 256 rows in 2 chunks of 128
N, R, CB, C, ROWS, CHUNK, MAX_ITER = 2, 4, 2, 9, 256, 128, 50
EPS, DECAY = 5.0, 0.25


def _setup(seed=3):
    gen = data.generator(seed, "cpu")
    X, y = cifar.images(gen, ROWS, 16, 8, 3, C + 1, 24.0, "cpu")
    P, q = X.shape[1], X.shape[2]
    model = train_image.build_model({"model_type": "tt_type1", "N": N, "r": R, "CB": CB,
                                     "seed": 0, "device": "cpu"}, P, q, C + 1)
    dims = [(n, P - (n > 1), q - (n > 1)) for n in range(1, N + 1)]
    w0 = []
    for layer, (n, Pm, qm) in zip(model.layers, dims):
        w = data.weights(gen, data.conv_tt_shapes(n, R, CB, Pm, qm, C), "cpu")
        layer.params = {k: w[k].reshape(v.shape) for k, v in layer.params.items()}
        w0.append(w)
    scale = 1.0 / float(model(X[:64]).std(unbiased=False))
    return X, y, model, dims, w0, scale


def _sweeper(model, scale):
    return Sweeper([Member(l.network, fn) for l, fn in zip(model.layers, model.input_fns)],
                   XEBregman(w=scale),
                   SweepConfig(num_swipes=1, batch_size=CHUNK, method="minres",
                               max_iter=MAX_ITER, eps=EPS, eps_decay=DECAY))


@pytest.fixture
def f32(monkeypatch):
    """The port's f32 numerics, and chunks that stay chunks (no full-batch
    merge)."""
    monkeypatch.delenv("TNF_AUX_PRECISION", raising=False)
    monkeypatch.delenv("TNF_GRAM_DTYPE", raising=False)
    monkeypatch.setenv("TNF_FULLBATCH_MAX_BYTES", "0")


def _rel(a, b):
    a, b = a.double().reshape(-1), b.double().reshape(-1)
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def test_swipe_matches_the_reference_at_each_updates_k(f32):
    X, y, model, dims, w0, scale = _setup()
    sw, losses = _sweeper(model, scale), []
    plist, ok = sw.run(model.params_list, X, y,
                       loss_callback=lambda ns, name, loss: losses.append(loss))
    assert ok
    ks = [int(k) for _, _, k in sw.krylov_iters]
    # every node, both passes less the junction's column: 4 + 8 - 2 updates
    assert len(ks) == len(losses) == 10 and 0 < min(ks) and max(ks) <= MAX_ITER
    ref = mf.Sum([mf.Member(w, n, P, q) for w, (n, P, q) in zip(w0, dims)])
    assert [(m, n) for p in mf.schedule(ref) for m, n in p] == [
        (m, n) for m, n, _ in sw.krylov_iters]
    ref_losses = mf.swipe(ref, X, y, scale, EPS, DECAY, ks)
    # float32 against float64, the same k: each update starts from a state
    # the earlier updates' f32 solves (up to 50 Lanczos steps each, ten in
    # a row) left a little off, and a wrong term would read O(1). Measured
    # on this seed: losses 1.7e-6, cores 3.6e-5 of their norm, forward
    # 2.8e-5; on seeds 3-7 at most 1.4e-5, 2.2e-4 and 1.0e-4.
    for a, b in zip(losses, ref_losses):
        assert abs(a - b) / b < 1e-5
    for p, mem in zip(plist, ref.members):
        for name, core in mem.p.items():
            assert _rel(p[name], core) < 3e-4, name
    model.set_params_list(plist)
    got = model.forward_batch(X, CHUNK)
    assert _rel(got, ref.forward(X)) < 2e-4


def test_the_counter_counts_every_matvec_launched(f32, monkeypatch):
    """One hessian_apply a chunk and a matvec (the linearisation calls
    none): the counter equals the matvecs run, and each solve launches its
    residual, the scale probe and its k iterations (on the CPU the host
    reads each flag as it is made, so no masked one; on a card at most
    krylov.LAG)."""
    X, y, model, _, _, scale = _setup(5)
    calls = []
    orig = Network.hessian_apply

    def hessian_apply(self, *a, **k):
        calls.append(1)
        return orig(self, *a, **k)
    monkeypatch.setattr(Network, "hessian_apply", hessian_apply)
    sw = _sweeper(model, scale)
    per_update, seen = [], []

    def on_update(ns, name):
        total = sum(sw.krylov_matvecs.values())
        per_update.append((total - (seen[-1][0] if seen else 0),
                           len(calls) - (seen[-1][1] if seen else 0)))
        seen.append((total, len(calls)))
    _, ok = sw.run(model.params_list, X, y, block_callback=on_update)
    assert ok
    nchunks = ROWS // CHUNK
    assert sum(sw.krylov_matvecs.values()) * nchunks == len(calls) > 0
    assert set(sw.krylov_matvecs) == {(m, n) for m, n, _ in sw.krylov_iters}
    for (mv, hv), (_, _, k) in zip(per_update, sw.krylov_iters):
        k = int(k)
        assert mv * nchunks == hv
        assert mv == k + 2


def _tnf_spans(prof):
    return [e.name() for e in prof.profiler.kineto_results.events()
            if e.is_user_annotation() and e.name().startswith("tnf.krylov.")
            and e.device_type() == torch.autograd.DeviceType.CPU]


@pytest.mark.parametrize("spans_env", ["1", None])
def test_krylov_spans_open_only_with_tnf_spans(f32, monkeypatch, spans_env):
    if spans_env is None:
        monkeypatch.delenv("TNF_SPANS", raising=False)
    else:
        monkeypatch.setenv("TNF_SPANS", spans_env)
    X, y, model, _, _, scale = _setup(6)
    sw = _sweeper(model, scale)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, ok = sw.run(model.params_list, X, y)
    assert ok
    names = _tnf_spans(prof)
    if spans_env is None:
        assert names == []
        return
    # a span a matvec, and a read of the flags each iteration the loop runs
    assert names.count("tnf.krylov.matvec") == sum(sw.krylov_matvecs.values())
    loops = [v - 1 for v in sw.krylov_matvecs.values()]  # the iterations run
    assert names.count("tnf.krylov.check") >= len(sw.krylov_iters) > 0
    assert names.count("tnf.krylov.check") <= sum(loops)


# ------------------------------------------------------------------ counts
CFG = {"model": {"N": 3, "r": 4, "CB": 2, "patches": 5, "patch_pixels": 193, "logits": 9}}


def test_matvec_flops_by_hand():
    """Member 3's middle core A2 and conv block C2 (the cell's D = 160,000
    nodes at r = 100) at this file's widths and rows: r = 4 both sides,
    CB = 2 both sides, 4 patches of 192 pixels, 9 logits, S = 256 rows."""
    S = ROWS
    # A2: J v = v·R (s r p R B) + ·(X·C) (s r p b B) + ·L (s c r b);
    # J^T u the same three; H u (s C C)
    jv = 2 * S * (4 * 4 * 4 * 2 + 4 * 4 * 2 * 2 + 9 * 4 * 2)
    assert matfree.matvec_flops(CFG, 2, "A2", S) == 2 * jv + 2 * S * 81
    # C2: J v = X·v (s p q b B) + ·R (s p b B R) + ·A (s p b R r) + ·L (s c r b)
    jv = 2 * S * (4 * 192 * 2 * 2 + 4 * 2 * 2 * 4 + 4 * 2 * 4 * 4 + 9 * 4 * 2)
    assert matfree.matvec_flops(CFG, 2, "C2", S) == 2 * jv + 2 * S * 81
    # its least bytes (f32): L, R, H, X·C, v and the result
    assert matfree.matvec_bytes(CFG, 2, "A2", S) == 4 * (
        S * 9 * 4 * 2 + S * 4 * 2 + S * 81 + S * 4 * 2 * 2 + 2 * 4 * 4 * 4)


def test_counts_equal_the_references_products():
    """FLOPs torch counts in the reference's J v and J^T u of each middle
    node, and in each environment step, equal the written-out counts (the
    outer carriages' products with size-1 axes lower to broadcasts, which
    torch's counter reads otherwise)."""
    gen, S = data.generator(1, "cpu"), 64
    X = torch.randn((S, 5, 193), generator=gen, dtype=torch.float64)
    for m, (n, P, q) in enumerate(matfree.members(CFG)):
        mem = mf.Member(data.weights(gen, data.conv_tt_shapes(n, 4, 2, P, q, 9), "cpu"),
                        n, P, q)
        Xm = mem.x(X)
        for i in range(2, n):
            for name in (f"A{i}", f"C{i}"):
                ops = mf.NodeOps(mem, X, name, Numerics())
                v = torch.randn(mem.p[name].shape, dtype=torch.float64)
                with FlopCounterMode(display=False) as fc:
                    ops.jtu(ops.jv(v))
                z = matfree._z(CFG, m, name)
                core = name[0] == "A"
                assert fc.get_total_flops() == (matfree.jv_flops(z, core, S)
                                                + matfree.jtu_flops(z, core, S))
        for i in range(1, n + 1):
            z = matfree.sizes(n, i, P, q, 4, 2, 9)
            for side, a, b in (("left", i, i - 1), ("right", i, i + 1)):
                env = mem.left if side == "left" else mem.right
                with FlopCounterMode(display=False) as fa:
                    env(Xm, a, Numerics())
                with FlopCounterMode(display=False) as fb:
                    env(Xm, b, Numerics())
                assert (fa.get_total_flops() - fb.get_total_flops()
                        == matfree.env_step_flops(z, side, S))


# ------------------------------------------------- the prepared Jacobian
def _member3(dtype, rows=384, chunk=128, seed=4):
    """Member 3 of an N = 3 sum at this file's widths (A1 first, A2 middle,
    A3 last, C2 a conv block), its weights from `seed`, in `dtype`, with
    its rows in chunks: (network, params, input_fn, X, y, scale, chunks)."""
    gen = data.generator(seed, "cpu")
    X, y = cifar.images(gen, rows, 16, 8, 3, C + 1, 24.0, "cpu")
    model = train_image.build_model({"model_type": "tt_type1", "N": 3, "r": R, "CB": CB,
                                     "seed": 0, "device": "cpu"}, X.shape[1], X.shape[2],
                                    C + 1)
    layer, fn = model.layers[2], model.input_fns[2]
    w = data.weights(gen, data.conv_tt_shapes(3, R, CB, X.shape[1] - 1, X.shape[2] - 1, C),
                     "cpu")
    params = {k: w[k].reshape(v.shape).to(dtype) for k, v in layer.params.items()}
    X = X.to(dtype)
    net = layer.network
    scale = 1.0 / float(net.forward(params, fn(X)).std(unbiased=False))
    return net, params, fn, X, y, scale, rows // chunk


def _chunk_ops(net, params, fn, X, ni, nchunks):
    t = net.topology
    ci, ncols = t.col_of[ni], len(t.columns)
    out = []
    for xc in X.chunk(nchunks):
        inputs = net.bind_inputs(fn(xc))
        left = net.env_chain(params, inputs, "left")
        right = net.env_chain(params, inputs, "right")
        out.append(net.jacobian_operands(ni, params, inputs,
                                         left[ci - 1] if ci > 0 else None,
                                         right[ci + 1] if ci < ncols - 1 else None))
    return out


def _one_update(net, params, fn, X, y, scale, ni, nchunks, monkeypatch, prepared, tol):
    """One MINRES update of node `ni` (one half-pass over it alone) from
    `params` at `tol`, on the prepared route or with it declined: (k, x, the
    new core, the share of its matvecs that ran prepared)."""
    sw = Sweeper([Member(net, fn)], XEBregman(w=scale),
                 SweepConfig(num_swipes=1, batch_size=X.shape[0] // nchunks,
                             method="minres", max_iter=MAX_ITER, tol=tol, eps=EPS,
                             skip_second=True))
    with monkeypatch.context() as m:
        if not prepared:
            m.setattr(Network, "prepare_jacobian", lambda self, ni, ops: None)
        plist, ok = sw.run([dict(params)], X, y, node_order=[(0, ni)])
    assert ok and len(sw.krylov_iters) == 1
    key = (0, net.topology.nodes[ni].name)
    return (int(sw.krylov_iters[0][2]), sw._node_sols[(0, ni)], plist[0][key[1]],
            sw.krylov_prepared[key] / sw.krylov_matvecs[key])


@pytest.mark.parametrize("dtype,tol,x_tol", [(torch.float64, 1e-12, 1e-8),
                                             (torch.float32, 1e-5, 2e-5)],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("node", ["A1", "A2", "A3", "C2"],
                         ids=["first core", "middle core", "last core", "conv block"])
def test_prepared_matvec_equals_the_einsums(f32, monkeypatch, node, dtype, tol, x_tol):
    """For the first, middle and last cores of a 3-carriage member the
    prepared route is taken, and its J v, Jᵀ u and whole matvec
    Σ_chunks Jᵀ H J v equal the einsums' to `tol` (the same sums in another
    order: measured 2e-16 - 6e-16 in float64, as a one-ulp change of J v
    moves the einsums' own); for the conv block it is declined (its M would
    exceed S·D). One MINRES update of the node from the same state then
    runs to the same k on both routes, its iterate and new core within
    `x_tol` of their norm: about twice what a one-ulp scaling of the state
    moves the einsum route's own (at most 5.2e-9 in float64 and 2.7e-6 in
    f32, measured). At tol 1e-3 the solves stop within 8-23 iterations;
    past about 25 this recurrence amplifies rounding so far that the
    stopping iteration is itself rounding's (at tol 1e-6 a one-ulp scaling
    of the state moves the einsum route's residual at iteration 26 by 20 %)."""
    net, params, fn, X, y, scale, nchunks = _member3(dtype)
    ni = [n.name for n in net.topology.nodes].index(node)
    gen = torch.Generator().manual_seed(9)
    v = torch.randn(params[node].shape, generator=gen, dtype=dtype)
    Av_e = Av_p = 0
    for ops, yc in zip(_chunk_ops(net, params, fn, X, ni, nchunks), y.chunk(nchunks)):
        prep = net.prepare_jacobian(ni, ops)
        assert (prep is None) == (node == "C2")
        if prep is None:
            continue
        Jv = net.jacobian_apply(ni, ops, v)
        assert _rel(prep.apply(v), Jv) < tol
        _, g, H = XEBregman(w=scale)(net.jacobian_apply(ni, ops, params[node]), yc)
        assert _rel(prep.transpose_apply(g), net.jacobian_transpose_apply(ni, ops, g)) < tol
        Av_e = Av_e + net.jacobian_transpose_apply(ni, ops, net.hessian_apply(H, Jv))
        Av_p = Av_p + prep.transpose_apply(net.hessian_apply(H, prep.apply(v)))
    if node != "C2":
        assert _rel(Av_p, Av_e) < tol
    (k_e, x_e, core_e, _), (k_p, x_p, core_p, share) = (
        _one_update(net, params, fn, X, y, scale, ni, nchunks, monkeypatch, prepared, 1e-3)
        for prepared in (False, True))
    assert k_p == k_e > 0
    assert share == (node != "C2")
    assert _rel(x_p, x_e) < x_tol and _rel(core_p, core_e) < x_tol


def test_hessian_apply_once_a_chunk_in_chunk_order_on_the_prepared_route(f32, monkeypatch):
    """A swipe of the sum in 4 chunks: each matvec of a prepared update
    calls hessian_apply once a chunk, in chunk order, each on its own
    chunk's J v (the benchmark's half-chunk fault counts on it); the conv
    blocks' matvecs, on the einsums, call it once a chunk too."""
    X, y, model, _, _, scale = _setup(8)
    log, made = [], []
    prepare, hessian_apply = Network.prepare_jacobian, Network.hessian_apply

    def logged_prepare(self, ni, ops):
        p = prepare(self, ni, ops)
        if p is not None:
            idx, apply = len(made), p.apply
            made.append(p)

            def logged_apply(v):
                out = apply(v)
                log.append(("J", idx, out))
                return out
            p.apply = logged_apply
        return p

    def logged_hessian_apply(self, H, u):
        log.append(("H", u))
        return hessian_apply(self, H, u)
    monkeypatch.setattr(Network, "prepare_jacobian", logged_prepare)
    monkeypatch.setattr(Network, "hessian_apply", logged_hessian_apply)
    nchunks = 4
    sw = Sweeper([Member(l.network, fn) for l, fn in zip(model.layers, model.input_fns)],
                 XEBregman(w=scale),
                 SweepConfig(num_swipes=1, batch_size=ROWS // nchunks, method="minres",
                             max_iter=MAX_ITER, eps=EPS, eps_decay=DECAY))
    _, ok = sw.run(model.params_list, X, y)
    assert ok and len(made) % nchunks == 0
    on_chunk = [log[i - 1][1] for i, e in enumerate(log)
                if e[0] == "H" and i > 0 and log[i - 1][0] == "J"]
    assert all(log[i - 1][2] is e[1] for i, e in enumerate(log)
               if e[0] == "H" and log[i - 1][0] == "J")
    prepared = sum(sw.krylov_prepared.values())
    assert 0 < prepared < sum(sw.krylov_matvecs.values())
    # each prepared update makes its chunks' operators in chunk order
    assert [i % nchunks for i in on_chunk] == list(range(nchunks)) * prepared
    einsum_calls = sum(1 for i, e in enumerate(log) if e[0] == "H"
                       and (i == 0 or log[i - 1][0] != "J"))
    assert einsum_calls == nchunks * (sum(sw.krylov_matvecs.values()) - prepared)


def test_solvers_are_looked_up_at_call_time(f32, monkeypatch):
    """`krylov.SOLVERS[method]` replaced after the Sweeper is built still
    runs every solve, on the prepared route as on the einsums."""
    from tensornetworksfork_tpu_torch.core import krylov
    X, y, model, _, _, scale = _setup(9)
    sw, calls = _sweeper(model, scale), []
    real = krylov.SOLVERS["minres"]

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)
    monkeypatch.setitem(krylov.SOLVERS, "minres", spy)
    _, ok = sw.run(model.params_list, X, y)
    assert ok and len(calls) == len(sw.krylov_iters) > 0
    assert sum(sw.krylov_prepared.values()) > 0


def test_prepared_counter_counts_the_prepared_matvecs(f32):
    """`Sweeper.krylov_prepared` has `krylov_matvecs`' keys: on the conv-TT
    sum it equals the matvecs of every core and is 0 at every conv block;
    on a type-I sum of tensor trains, cores alone, it equals them."""
    from tensornetworksfork_tpu_torch.models.layers import TensorTrainLayer
    X, y, model, _, _, scale = _setup(10)
    sw = _sweeper(model, scale)
    _, ok = sw.run(model.params_list, X, y)
    assert ok and set(sw.krylov_prepared) == set(sw.krylov_matvecs)
    for (m, name), n in sw.krylov_matvecs.items():
        assert sw.krylov_prepared[(m, name)] == (n if name[0] == "A" else 0) and n > 0
    gen = torch.Generator().manual_seed(10)
    Xt = torch.randn((ROWS, 5), generator=gen)
    yt = torch.eye(4)[torch.randint(0, 4, (ROWS,), generator=gen)]
    layers = [TensorTrainLayer(n, 3, 5, output_shape=(3,), seed=n, device="cpu")
              for n in (2, 3)]
    sw = Sweeper([Member(l.network) for l in layers], XEBregman(w=1.0),
                 SweepConfig(num_swipes=1, batch_size=CHUNK, method="minres",
                             max_iter=MAX_ITER, eps=EPS))
    _, ok = sw.run([l.params for l in layers], Xt, yt)
    assert ok and sw.krylov_prepared == sw.krylov_matvecs and len(sw.krylov_matvecs) == 5


def test_prepared_route_declined_when_sharded_or_complex(monkeypatch):
    """A core whose operands the route splits is declined under the model
    sharding (its `_tp_contract` path) and for complex operands."""
    net, params, fn, X, _, _, _ = _member3(torch.float32, rows=64, chunk=64)
    ni = [n.name for n in net.topology.nodes].index("A2")
    (ops,) = _chunk_ops(net, params, fn, X, ni, 1)
    assert net.prepare_jacobian(ni, ops) is not None
    assert net.prepare_jacobian(ni, [(a, o.to(torch.complex64)) for a, o in ops]) is None
    axis = net.topology.node_axes[ni][1]
    monkeypatch.setattr(net, "model_blocks", {axis: (0, net.topology.axis_size[axis])})
    assert net.prepare_jacobian(ni, ops) is None
