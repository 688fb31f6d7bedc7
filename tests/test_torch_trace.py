"""The port's spans (`utils/timing.py` `span`): a small conv-TT swipe and a
served call under `torch.profiler` on the CPU with TNF_SPANS=1, the same
with the profiler off, and under the profiler without TNF_SPANS."""
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tensornetworksfork_tpu_torch.core import sweep as tsweep
from tensornetworksfork_tpu_torch.core.sweep import SweepConfig, Sweeper
from tensornetworksfork_tpu_torch.models.layers import TensorConvolutionTrainLayer
from tensornetworksfork_tpu_torch.ops.bregman import XEBregman
from tensornetworksfork_tpu_torch.utils import timing
from tensornetworksfork_tpu_torch.utils.serving import export_forward, load_forward

N, R, CB, P, PP, C, S, B = 4, 4, 2, 6, 5, 3, 64, 32
NODES = ("A1", "A2", "A3", "A4", "C1", "C2", "C3", "C4")
INNER = ("tnf.solve", "tnf.update.jacobian", "tnf.update.gram")


def _layer():
    return TensorConvolutionTrainLayer(N, R, P, PP, output_shape=(C,), convolution_bond=CB,
                                       seed=0, device="cpu")


def _data():
    rng = np.random.default_rng(0)
    X = rng.standard_normal((S, P, PP)).astype(np.float32)
    Y = np.eye(C + 1, dtype=np.float32)[rng.integers(0, C + 1, S)]
    return torch.tensor(X), torch.tensor(Y)


def _swipe(**cfg):
    """One swipe of the tiny conv-TT in two chunks (the chunk loop, not the
    full-batch merge), with a loss callback; returns the nodes visited."""
    layer, (X, Y), visits = _layer(), _data(), []
    sw = Sweeper(layer.network, XEBregman(1.0), SweepConfig(
        num_swipes=1, batch_size=B, method="ridge_cholesky", eps=5.0, eps_decay=0.25, **cfg))
    _, ok = sw.run([layer.params], X, Y, loss_callback=lambda *a: None,
                   block_callback=lambda ns, name: visits.append(name))
    assert ok
    return visits


def _spans(prof, prefix="tnf."):
    """(start, end, name) of the profile's CPU user annotations named
    `prefix*`."""
    return sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                  for e in prof.profiler.kineto_results.events()
                  if e.is_user_annotation() and e.name().startswith(prefix)
                  and e.device_type() == torch.autograd.DeviceType.CPU)


def _inside(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


@pytest.fixture
def spans_on(monkeypatch):
    monkeypatch.setenv("TNF_SPANS", "1")


@pytest.fixture
def traced(monkeypatch, spans_on):
    monkeypatch.setenv("TNF_GRAM_DTYPE", "f32")
    monkeypatch.setenv("TNF_PACKED_SYRK_MIN_D", "1")
    monkeypatch.setenv("TNF_FULLBATCH_MAX_BYTES", "0")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        visits = _swipe(orthonormalize=True)
    return _spans(prof), visits


def test_swipe_opens_every_span(traced):
    spans, _ = traced
    names = {n for _, _, n in spans}
    assert {"tnf.sweep.run", "tnf.env.far", "tnf.env.advance", "tnf.env.gauge",
            "tnf.sync.flush_ok", "tnf.sync.loss", *INNER} <= names
    assert {f"tnf.update:{n}" for n in NODES} == {n for n in names if n.startswith("tnf.update:")}


def test_update_spans_nest(traced):
    """Each solve, Jacobian and Gram span lies inside a node update, and
    each node update inside the sweep's call."""
    spans, _ = traced
    runs = [s for s in spans if s[2] == "tnf.sweep.run"]
    updates = [s for s in spans if s[2].startswith("tnf.update:")]
    assert len(runs) == 1
    assert all(_inside(u, runs[0]) for u in updates)
    for s in spans:
        if s[2] in INNER:
            assert any(_inside(s, u) for u in updates), s
    # the chunk loop: a Jacobian and a Gram span for each of the two chunks,
    # and the Gram's finish, in every dense update
    per = {u: [s[2] for s in spans if s[2] in INNER and _inside(s, u)] for u in updates}
    for u, inner in per.items():
        assert inner.count("tnf.update.jacobian") == 2 and inner.count("tnf.update.gram") == 3, u
        assert inner.count("tnf.solve") == 1, u


def test_one_update_span_per_node_visit(traced):
    spans, visits = traced
    updates = [n[len("tnf.update:"):] for _, _, n in spans if n.startswith("tnf.update:")]
    assert sorted(updates) == sorted(visits) and len(visits) > len(NODES)


def test_spans_off_enter_no_record_function(monkeypatch, spans_on):
    """Without a running profiler a span is one check and no
    `record_function`, in the sweep and in a served call, TNF_SPANS=1 or
    not."""
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with the profiler off")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setenv("TNF_GRAM_DTYPE", "f32")
    assert timing.span("tnf.x") is timing.span("tnf.y")
    with timing.span("tnf.x"):
        pass
    _swipe()
    layer = _layer()
    f = load_forward(export_forward(layer, (P, PP), device="cpu"))
    f(_data()[0][:4])


def test_served_call_opens_its_spans(spans_on):
    layer = _layer()
    f = load_forward(export_forward(layer, (P, PP), device="cpu"))
    x = _data()[0][:8].numpy()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = f(x)
    np.testing.assert_allclose(out.numpy(), layer(torch.from_numpy(x)).numpy(),
                               rtol=1e-5, atol=1e-5)
    assert [n for _, _, n in _spans(prof)] == ["tnf.serve.call"]


def test_profiler_without_tnf_spans_records_none(monkeypatch):
    """Under a running profiler the spans stay off unless TNF_SPANS=1: a
    swipe, a served call and a `Timer` phase leave no `tnf.*` range, and
    the swipe visits the same nodes."""
    monkeypatch.delenv("TNF_SPANS", raising=False)
    monkeypatch.setenv("TNF_GRAM_DTYPE", "f32")
    layer = _layer()
    f = load_forward(export_forward(layer, (P, PP), device="cpu"))
    timer = timing.Timer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        visits = _swipe()
        f(_data()[0][:4])
        with timer.phase("train"):
            pass
    assert _spans(prof) == [] and len(visits) > len(NODES)
    assert timer.counts["train"] == 1


def test_timer_phase_opens_a_span(spans_on):
    timer = timing.Timer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timer.phase("train"):
            torch.ones(3).sum()
    assert [n for _, _, n in _spans(prof)] == ["tnf.phase:train"]
    assert timer.counts["train"] == 1


def test_benchmark_solve_patch_wraps_every_solve(monkeypatch, spans_on):
    """The benchmark's sweep entry wraps `core.sweep.solve_block` in a span
    of its own; the sweep looks the function up at each call, so every
    `tnf.solve` holds one."""
    from portbench.drivers.sweep import Driver
    monkeypatch.setenv("TNF_GRAM_DTYPE", "f32")
    orig = tsweep.solve_block
    drv = Driver(types.SimpleNamespace(config={}, workload={}))
    with profile(activities=[ProfilerActivity.CPU]) as prof, drv.spans():
        visits = _swipe()
    assert tsweep.solve_block is orig
    mine = [s for s in _spans(prof) if s[2] == "tnf.solve"]
    theirs = _spans(prof, "portbench.solve")
    assert len(mine) == len(theirs) == len(visits)
    assert all(_inside(t, m) for t, m in zip(theirs, mine))
