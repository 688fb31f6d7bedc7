"""The matrix-free cell (`cifar_minres.train`, entry `matfree_sum`) at test
size on the CPU: the driver runs through the harness, the check reads a
sound program within the cell's own limits and reads faults above them
(half of the chunks in the program's matvec, a state left unchanged, a
failed solve, the fp8 control, the reference's half-chunk fault), and the
readers return None where they have nothing to read."""
import json

import pytest
import torch

from pb_tiny import run
from portbench import harness

NAME = "cifar_minres.train"


def cell(seed: int = 7, **over) -> harness.Cell:
    """pb_tiny's widths: members of 1-3 carriages, r=6, CB=4, 3 x 16 x 16
    images (5 x 193 patches), 512 rows in 4 chunks. Two things differ from
    the cell, each forced by the size: the followed nodes are member 2's
    core A2 and conv block C2 (with so few rows the ridge outweighs member
    3's A^T H A and drives that member to zero, where the update reduces to
    x = -node); and the
    tier is `reference` (f32 aux), because the bf16 aux's rounding does not
    average out over 512 rows and 6-wide bonds as it does at the cell's
    width: at this size its loss_gap reads 7e-5 to 4e-4, at the cell's
    width under 1e-6, and the limit is the full width's."""
    cfg = harness.load_json("configs", "cifar_minres")
    cfg = json.loads(json.dumps(cfg))
    cfg["model"].update(N=3, r=6, CB=4, patches=5)
    cfg["data"].update(side=16)
    cfg["training"].update(chunk=128)
    wl = harness.load_json("workloads", NAME)
    wl.update(rows=512, trace_units=2, eval_batch=128, tier="reference",
              follow=[{"member": 2, "node": "A2", "tag": ""},
                      {"member": 2, "node": "C2", "tag": "conv_"}])
    wl.update(over)
    return harness.Cell(NAME, seed, torch.device("cpu"), config=cfg, workload=wl)


@pytest.fixture(autouse=True)
def chunked(monkeypatch):
    """Every node's chunks stay chunks, as the D = 160,000 nodes' do at full
    size (the full-batch merge would make the test's one chunk)."""
    monkeypatch.setenv("TNF_FULLBATCH_MAX_BYTES", "0")


def in_window(monkeypatch, cls, name, broken):
    """`broken` in place of `cls.name` once set-up is over."""
    orig, window, on = getattr(cls, name), harness.window, []

    def start(*a, **k):
        on.append(True)
        return window(*a, **k)

    def patched(self, *a, **k):
        return broken(self, orig, *a, **k) if on else orig(self, *a, **k)
    monkeypatch.setattr(harness, "window", start)
    monkeypatch.setattr(cls, name, patched)


def half_the_chunks(monkeypatch, window_only):
    """The program's matvec sums the first half of the chunks at weight 2
    and leaves out the rest; b and the loss keep every row."""
    from tensornetworksfork_tpu_torch.core.engine import Network
    nchunks, seen = 4, [0]

    def hessian_apply(self, orig, H, u):
        i, seen[0] = seen[0], seen[0] + 1
        return orig(self, H, u) * (2.0 if i % nchunks < nchunks // 2 else 0.0)
    if window_only:
        in_window(monkeypatch, Network, "hessian_apply", hessian_apply)
    else:
        orig = Network.hessian_apply
        monkeypatch.setattr(Network, "hessian_apply",
                            lambda self, H, u: hessian_apply(self, orig, H, u))


METRICS = ("step_mfu.minres", "krylov_ms_per_swipe.minres", "matvec_roofline.minres",
           "krylov_matvecs_per_swipe.minres", "device_idle_share.train", "aux_ms_per_swipe.train")


def test_the_benchmark_lists_the_cell_and_its_metrics():
    e2e, layer = harness.cell_metrics(harness.benchmark(), NAME)
    assert {m["name"] for m in e2e} == {"swept_samples_per_s", "setup_s"}
    assert {m["name"] for m in layer} == set(METRICS)


def test_sound_run_is_correct_and_reads_its_metrics():
    out = run(cell(), trace=1)
    assert out["correct"] and out["failed"] == 0
    for k, v in out["compared"].items():
        assert v["value"] <= v["limit"], k
    m = out["metrics"]
    assert m["step_mfu.minres"]["value"] > 0
    assert m["krylov_matvecs_per_swipe.minres"]["value"] >= 2 * 10
    # the CPU run has no device time: the solve reads 0 ms and the roofline
    # nothing
    assert m["krylov_ms_per_swipe.minres"]["value"] == 0.0
    assert "matvec_roofline.minres" not in m


def _cloned(v):
    """`v` with its containers and tensors copied."""
    if isinstance(v, dict):
        return {k: _cloned(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_cloned(x) for x in v)
    return v.clone() if isinstance(v, torch.Tensor) else v


def _same(a, b) -> bool:
    """Bit-equal tensors in containers of the same shape."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(map(_same, a, b))
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and torch.equal(a, b)
    return a == b


def test_every_window_epoch_repeats_the_second():
    """A window of 3 units: each runs training's second epoch from the state
    set-up kept, so each records the first unit's (member, node, k) list and
    ends with its parameters bit for bit, and the kept state is untouched."""
    c = cell()
    drv = harness.driver_for(c)
    drv.setup()
    kept = _cloned(drv.start)
    assert kept["_node_sols"] and kept["_near_hist"]
    ends, unit = [], drv.unit

    def unit_and_params():
        out = unit()
        ends.append(drv.params)
        return out
    drv.unit = unit_and_params
    stats = harness.window(drv, 1e9, 3)
    assert stats["units"] == 3 and stats["failed"] == 0
    ups = drv.detail()["updates"]
    assert ups[0] and ups[1] == ups[0] and ups[2] == ups[0]
    assert not _same(ends[0], kept["params"])
    assert _same(ends[1], ends[0]) and _same(ends[2], ends[0])
    assert _same(drv.start, kept)


@pytest.mark.parametrize("window_only", [False, True], ids=["from_the_start", "in_the_window"])
def test_half_the_chunks_in_the_matvec(monkeypatch, window_only):
    half_the_chunks(monkeypatch, window_only)
    out = run(cell())
    assert not out["correct"]
    gap = "last_solve_gap" if window_only else "solve_gap"
    assert out["compared"][gap]["value"] > out["compared"][gap]["limit"]


def test_state_left_unchanged(monkeypatch):
    from tensornetworksfork_tpu_torch.core.sweep import Sweeper

    def update(self, orig, net, mid, ni, method, core, *a, **k):
        _, loss, ok, x = orig(self, net, mid, ni, method, core, *a, **k)
        return core, loss, ok, x
    in_window(monkeypatch, Sweeper, "_update_matrix_free", update)
    out = run(cell())
    assert not out["correct"]
    assert out["compared"]["last_solve_gap"]["value"] >= 1.0


def test_a_failed_solve_is_not_correct(monkeypatch):
    from tensornetworksfork_tpu_torch.core.sweep import Sweeper

    def run_(self, orig, *a, **k):
        plist, _ = orig(self, *a, **k)
        return plist, False
    in_window(monkeypatch, Sweeper, "run", run_)
    out = run(cell())
    assert not out["correct"] and out["failed"] >= 1


@pytest.mark.parametrize("variant", ["control", "half"])
def test_control_and_fault_fail_a_limit(variant):
    c = cell()
    drv = harness.driver_for(c)
    drv.setup()
    harness.window(drv, 0.2)
    drv.release()
    got = drv.check((variant,))[variant]
    limits = c.workload["limits"]
    assert any(got[k] > limits[k] for k in got), (got, limits)


def test_the_matvec_controls_read_above_the_program():
    """The reference with its matvec's operands rounded to TF32 or bf16
    reads each followed update's solve 10x or more above the program's f32
    matvec, and bf16 above TF32 (at test size the program's aux is f32, so
    its gap is rounding alone)."""
    c = cell()
    drv = harness.driver_for(c)
    drv.setup()
    harness.window(drv, 0.2)
    drv.release()
    got = drv.check(("program", "tf32mv", "bf16mv"))
    for k in ("solve_gap", "conv_solve_gap"):
        assert got["tf32mv"][k] > 10 * got["program"][k], k
        assert got["bf16mv"][k] > got["tf32mv"][k], k


@pytest.mark.parametrize("kind,bits", [("tf32", 10), ("bf16", 7)])
def test_rounded_keeps_the_kinds_mantissa(kind, bits):
    from portbench.reference.matfree_sum import rounded
    x = torch.randn(4096, dtype=torch.float64) * 1e3
    r = rounded(x, kind)
    # within half a unit in the last kept place, and on that grid
    assert ((r - x).abs() <= 2.0 ** -(bits + 1) * x.abs() * 1.0001).all()
    m, _ = torch.frexp(r)
    assert torch.equal(m * 2 ** (bits + 1), (m * 2 ** (bits + 1)).round())
    assert rounded(x, None) is x


def test_readers_return_none_without_a_trace():
    c = cell()
    for detail in ({}, {"updates": [[(0, "A1", 3)]], "matvecs": [5]}):
        ctx = harness.Context(c, {"units": 1}, None, detail)
        for m in ("step_mfu.minres", "krylov_ms_per_swipe.minres", "matvec_roofline.minres"):
            assert harness.reader(m)(ctx) is None, m
    # a program that keeps no matvec count (the parent of the counter)
    ctx = harness.Context(c, {"units": 1}, None, {"updates": [[]], "matvecs": [None]})
    assert harness.reader("krylov_matvecs_per_swipe.minres")(ctx) is None
    ctx = harness.Context(c, {"units": 2}, None, {"updates": [[], []], "matvecs": [40, 44]})
    assert harness.reader("krylov_matvecs_per_swipe.minres")(ctx) == 42


def test_roofline_and_mfu_read_the_counts():
    from portbench.counts import matfree
    from portbench.counts.flops import peaks

    class T:
        window_s = 2.0

        @staticmethod
        def split():
            return {"port": 0.0, "solve": 0.5, "other": 1.0}
    c = cell()
    ups = [[(2, "A2", 7), (1, "C1", 3)]]
    ctx = harness.Context(c, {"units": 1}, T(), {"updates": ups, "matvecs": [20]})
    rows = c.workload["rows"]
    assert harness.reader("matvec_roofline.minres")(ctx) == pytest.approx(
        100 * matfree.least_matvec_s(c.config, rows, ups[0]) / 0.5)
    assert harness.reader("step_mfu.minres")(ctx) == pytest.approx(
        100 * matfree.swipe_flops(c.config, rows, ups[0]) / 2.0
        / peaks()["mfu_peak"][c.workload["tier"]])
    assert harness.reader("krylov_ms_per_swipe.minres")(ctx) == pytest.approx(500.0)
