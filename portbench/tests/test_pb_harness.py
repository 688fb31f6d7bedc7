"""The harness's files, names and arithmetic."""
import importlib
import json
import re
from pathlib import Path

import pytest
import torch

from portbench import harness
from portbench.trace import Trace

PB = Path(__file__).resolve().parents[1]
ROOT = PB.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("path", sorted((PB / "configs").glob("*.json"))
                         + sorted((PB / "workloads").glob("*.json")), ids=lambda p: p.name)
def test_data_files_load(path):
    assert isinstance(json.loads(path.read_text()), dict)


@pytest.mark.parametrize("path", sorted((PB / "metrics").glob("*.py")), ids=lambda p: p.name)
def test_metric_readers_load(path):
    if path.name == "__init__.py":
        return
    assert callable(harness.reader(path.stem))


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cells_resolve(w):
    cell = harness.Cell(w["name"], 1, torch.device("cpu"))
    assert cell.workload["config"] == w["config"]
    assert w["chips"] == 1 and len(w["why"]) <= 200
    cfg = next(c for c in BENCH["configs"] if c["name"] == w["config"])
    assert (ROOT / cfg["file"]).exists()
    assert json.loads((ROOT / cfg["file"]).read_text())["reduced"] == cfg["reduced"]
    importlib.import_module(f"portbench.drivers.{cell.workload['entry']}").Driver
    e2e, layer = harness.cell_metrics(BENCH, w["name"])
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2 and layer
    for m in e2e + layer:
        assert (PB / "metrics" / f"{m['name']}.py").exists(), m["name"]
    assert set(cell.workload["limits"])


def test_file_names_are_not_the_suites():
    mine = {p.name for p in (PB / "tests").glob("*.py")} - {"conftest.py", "__init__.py"}
    theirs = {p.name for p in (ROOT / "tests").glob("*.py")}
    assert not mine & theirs


# ------------------------------------------------------- synthetic timelines
class Ev:
    def __init__(self, name, start, dur, cpu=True, corr=0, linked=0):
        self._n, self._s, self._d, self._cpu, self._c, self._l = name, start, dur, cpu, corr, linked

    def name(self):
        return self._n

    def device_type(self):
        return torch.autograd.DeviceType.CPU if self._cpu else torch.autograd.DeviceType.CUDA

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def correlation_id(self):
        return self._c

    def linked_correlation_id(self):
        return self._l

    def is_user_annotation(self):
        return False


class Prof:
    def __init__(self, events):
        self.profiler = type("P", (), {"kineto_results": type(
            "K", (), {"events": lambda _self: events})()})()


def timeline(solve_span=True):
    ms = 1_000_000
    span = [Ev("portbench.solve", 29 * ms, 22 * ms)] if solve_span else []
    return Trace(Prof(span + [
        Ev("portbench.window", 0, 100 * ms),
        Ev("portbench.window", 0, 100 * ms, cpu=False),
        # host ops carry their own correlation id; a device operation links
        # to the op that launched it, and its own id is the runtime call's
        Ev("aten::mm", 5 * ms, 10 * ms, corr=1), Ev("cudaLaunchKernel", 6 * ms, 1, corr=11),
        Ev("aten::linalg_cholesky_ex", 30 * ms, 20 * ms, corr=2),
        Ev("aten::_cholesky_solve_helper", 32 * ms, 5 * ms, corr=4),
        Ev("cudaLaunchKernel", 33 * ms, 1, corr=12),
        Ev("aten::copy_", 60 * ms, 5 * ms, corr=3), Ev("cudaLaunchKernel", 61 * ms, 1, corr=13),
        Ev("sm90_gemm", 10 * ms, 20 * ms, cpu=False, corr=11, linked=1),
        Ev("gram_q_kernel<int>", 25 * ms, 10 * ms, cpu=False, corr=19, linked=9),
        Ev("potrf_kernel", 40 * ms, 15 * ms, cpu=False, corr=12, linked=4),
        Ev("copy_kernel", 90 * ms, 20 * ms, cpu=False, corr=13),
    ]))


def test_trace_arithmetic():
    t = timeline()
    assert t.window_s == pytest.approx(0.1)
    # [10, 35] + [40, 55] + [90, 100]: 50 ms busy of 100
    assert t.busy_s() == pytest.approx(0.050)
    split = t.split()
    assert split["port"] == pytest.approx(0.010)
    assert split["solve"] == pytest.approx(0.015)
    assert split["other"] == pytest.approx(0.020 + 0.010)
    # the solve's kernels are those launched inside the benchmark's span
    assert timeline(solve_span=False).split()["solve"] is None
    c = ctx({"units": 2}, trace=t)
    assert harness.reader("solve_ms_per_swipe.train")(c) == pytest.approx(7.5)
    assert harness.reader("solve_ms_per_swipe.train")(
        ctx({"units": 2}, trace=timeline(solve_span=False))) is None
    gaps = dict((round(s, 6), n) for n, s in t.idle_gaps())
    assert gaps == {0.035: "aten::copy_", 0.010: "aten::mm", 0.005: "aten::linalg_cholesky_ex"}
    assert t.top_ops()[0] == ("sm90_gemm", pytest.approx(0.020))


def ctx(stats=None, detail=None, trace=None, name="convtt_mnist.fastest.train"):
    return harness.Context(harness.Cell(name, 1, torch.device("cpu")),
                           stats or {}, trace, detail)


def test_rates_tail_and_idle():
    c = ctx({"work": 53248 * 4, "seconds": 8.0, "units": 4, "setup_s": 9.5})
    assert harness.reader("swept_samples_per_s")(c) == pytest.approx(26624.0)
    assert harness.reader("setup_s")(c) == 9.5
    lat = [0.001] * 950 + [0.005] * 50
    c = ctx(detail={"latency_s": lat, "enqueue_s": [2e-5] * 1000}, name="convtt_mnist.serve")
    assert 1.0 <= harness.reader("serve_p95_ms")(c) <= 5.0
    assert harness.reader("serve_enqueue_us")(c) == pytest.approx(20.0)
    c = ctx({"units": 1}, trace=timeline())
    assert harness.reader("device_idle_share.train")(c) == pytest.approx(50.0)


def test_roofline_and_mfu_use_the_frozen_counts():
    from portbench.counts import cell as counts
    from portbench.counts.flops import peaks
    t = timeline()
    c = ctx({"units": 2}, trace=t)
    least = counts.unit_least_s(c.cell)
    assert harness.reader("kernel_roofline.train")(c) == pytest.approx(
        100 * 2 * least / t.split()["port"])
    mfu = harness.reader("step_mfu.train")(c)
    assert mfu == pytest.approx(100 * 2 * counts.unit_flops(c.cell) / 0.1
                                / peaks()["mfu_peak"]["fastest"])
    assert harness.reader("kernel_roofline.train")(ctx({"units": 1})) is None
