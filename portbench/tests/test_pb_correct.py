"""`correct` at test size on the CPU: a run with the timed path broken
underneath comes out not correct, once for each fault the cell can have
(from the start, and in the window alone), and so does the control (the
reference in the control's numerics in the program's place). The limits
are the cells' own."""
import pytest

from pb_tiny import cell, run

TRAIN = ["convtt_mnist.fastest.train", "convtt_mnist.fast.train", "convtt_mnist.reference.train"]


def in_window(monkeypatch, cls, name, broken):
    """`broken` in place of `cls.name` once set-up is over: the fault is in
    the window's epochs alone."""
    from portbench import harness
    orig, window, on = getattr(cls, name), harness.window, []

    def start(*a, **k):
        on.append(True)
        return window(*a, **k)

    def patched(self, *a, **k):
        return broken(self, orig, *a, **k) if on else orig(self, *a, **k)
    monkeypatch.setattr(harness, "window", start)
    monkeypatch.setattr(cls, name, patched)


@pytest.fixture
def unchanged(monkeypatch):
    """A node update that returns its state unchanged."""
    from tensornetworksfork_tpu_torch.core.sweep import Sweeper
    orig = Sweeper._update_dense

    def update(self, net, ni, plan, method, core, *a, **k):
        _, loss, ok = orig(self, net, ni, plan, method, core, *a, **k)
        return core, loss, ok
    monkeypatch.setattr(Sweeper, "_update_dense", update)


@pytest.fixture
def half_batch(monkeypatch):
    """Half of each chunk's rows left out, the mean taken over the rest."""
    from tensornetworksfork_tpu_torch.core.sweep import Sweeper
    orig = Sweeper._prepare

    def prepare(self, *a, **k):
        data = orig(self, *a, **k)
        w = data["w"].clone()
        half = w.shape[1] // 2
        w[:, :half] *= 2
        w[:, half:] = 0
        data["w"] = w
        return data
    monkeypatch.setattr(Sweeper, "_prepare", prepare)


def served(monkeypatch, alter):
    from tensornetworksfork_tpu_torch.utils import serving
    orig = serving.load_forward

    def load(blob):
        f = orig(blob)

        def g(x):
            return alter(f(x).clone())
        return g
    monkeypatch.setattr(serving, "load_forward", load)


@pytest.mark.parametrize("name", TRAIN)
def test_sound_run_is_correct(name):
    assert run(cell(name))["correct"]


@pytest.mark.parametrize("name", TRAIN)
def test_state_left_unchanged(name, unchanged):
    assert not run(cell(name))["correct"]


@pytest.mark.parametrize("name", TRAIN)
def test_half_the_batch_left_out(name, half_batch):
    assert not run(cell(name))["correct"]


@pytest.mark.parametrize("name", TRAIN)
def test_state_left_unchanged_in_the_window(name, monkeypatch):
    from tensornetworksfork_tpu_torch.core.sweep import Sweeper

    def update(self, orig, net, ni, plan, method, core, *a, **k):
        _, loss, ok = orig(self, net, ni, plan, method, core, *a, **k)
        return core, loss, ok
    in_window(monkeypatch, Sweeper, "_update_dense", update)
    out = run(cell(name))
    assert not out["correct"]
    assert out["compared"]["loss_gap"]["value"] <= out["compared"]["loss_gap"]["limit"]


@pytest.mark.parametrize("name", TRAIN)
def test_chunks_past_the_second_dropped_in_the_window(name, monkeypatch):
    """Each update of the window's epochs sees only the first two chunks."""
    from tensornetworksfork_tpu_torch.core.sweep import Sweeper

    def prepare(self, orig, *a, **k):
        data = dict(orig(self, *a, **k))
        w = data["w"].clone()
        w[2:] = 0
        data["w"] = w
        return data
    in_window(monkeypatch, Sweeper, "_prepare_cached", prepare)
    assert not run(cell(name))["correct"]


@pytest.mark.parametrize("name", TRAIN)
def test_a_failed_solve_is_not_correct(name, monkeypatch):
    from tensornetworksfork_tpu_torch.core.sweep import Sweeper

    def run_(self, orig, *a, **k):
        plist, _ = orig(self, *a, **k)
        return plist, False
    in_window(monkeypatch, Sweeper, "run", run_)
    out = run(cell(name))
    assert not out["correct"] and out["failed"] >= 1


def test_serve_sound():
    assert run(cell("convtt_mnist.serve"))["correct"]


def test_serve_answer_altered(monkeypatch):
    def alter(y):
        y[0, 0] += 0.5 * y.abs().max()
        return y
    served(monkeypatch, alter)
    assert not run(cell("convtt_mnist.serve"))["correct"]


def test_serve_half_the_batch_left_out(monkeypatch):
    def alter(y):
        y[y.shape[0] // 2:] = 0
        return y
    served(monkeypatch, alter)
    assert not run(cell("convtt_mnist.serve"))["correct"]


@pytest.mark.parametrize("name", TRAIN + ["convtt_mnist.serve"])
def test_control_is_not_correct(name):
    from portbench import harness
    c = cell(name)
    drv = harness.driver_for(c)
    drv.setup()
    harness.window(drv, 0.2)
    drv.release()
    got = drv.check(("control",))["control"]
    limits = c.workload["limits"]
    assert any(got[k] > limits[k] for k in limits), (got, limits)
