"""The port's native host runtime (`tensornetworksfork_tpu_torch/native`,
`utils/data_stream.py`) held against the JAX package's.

Every case of the JAX package's tests/test_native.py runs on the port; the
port's parsers read the same arrays as the JAX package's library; its
MinibatchStream yields the JAX package's index sequence for the same seed
(the same mt19937_64 shuffle, compared index by index); and
`TensorTrainBatchRegressor(stream="native")` reproduces the JAX package's
fit from copied initial params within 1e-4 x max|pred| (the tolerance of
tests/test_torch_module.py for the default stream). Without the library the
native stream raises with g++'s error instead of taking the numpy
permutation.
"""
import struct

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from tensornetworksfork_tpu import native as jnative  # noqa: E402
from tensornetworksfork_tpu.utils.data_stream import MinibatchStream as JStream  # noqa: E402
from tensornetworksfork_tpu_torch import native  # noqa: E402
from tensornetworksfork_tpu_torch.utils import data_stream  # noqa: E402
from tensornetworksfork_tpu_torch.utils.data_stream import MinibatchStream  # noqa: E402

PRED_REL = 1e-4


def _write_idx(path, arr):
    with open(path, "wb") as f:
        f.write(struct.pack(">I", 0x00000800 | arr.ndim))
        for d in arr.shape:
            f.write(struct.pack(">I", d))
        f.write(arr.tobytes())


def _csv(path, text):
    with open(path, "w") as f:
        f.write(text)
    return str(path)


def test_native_builds_under_build_dir():
    """The library builds with g++ into build/tnf_native/, not into the
    package, and exposes the stream entry points."""
    lib = native.get_lib()
    assert lib is not None, native.build_error()
    assert native.lib_path().parent == native.BUILD_DIR
    assert native.BUILD_DIR.parts[-2:] == ("build", "tnf_native")
    assert hasattr(lib, "tnf_stream_open_mem") and native.build_error() is None


# ---------------------------------------------------- JAX test_native.py cases
def test_native_idx_roundtrip(tmp_path):
    arr = np.random.default_rng(0).integers(0, 255, (7, 5, 4), np.uint8)
    p = str(tmp_path / "test.idx")
    _write_idx(p, arr)
    out = native.read_idx(p)
    assert out is not None
    np.testing.assert_array_equal(out, arr)


def test_native_csv(tmp_path):
    p = _csv(tmp_path / "t.csv", "a,b,c\n1.5,2,3\n-4,5.25,6\n")
    mat, ncols = native.parse_csv(p, skip_header=True)
    assert ncols == 3
    np.testing.assert_allclose(mat, [[1.5, 2, 3], [-4, 5.25, 6]])


def test_native_csv_empty_cells_keep_position(tmp_path):
    p = _csv(tmp_path / "e.csv", "1,,3\n,5,\n7,abc,9\n")
    mat, ncols = native.parse_csv(p, skip_header=False)
    assert ncols == 3
    np.testing.assert_allclose(mat, [[1, 0, 3], [0, 5, 0], [7, 0, 9]])


def test_native_csv_whitespace_cells(tmp_path):
    p = _csv(tmp_path / "w.csv", "1,2, \n3,4,\n 5 ,6, 7 \n")
    mat, ncols = native.parse_csv(p, skip_header=False)
    assert ncols == 3
    np.testing.assert_allclose(mat, [[1, 2, 0], [3, 4, 0], [5, 6, 7]])


def test_native_csv_trailing_whitespace_line(tmp_path):
    p = _csv(tmp_path / "tw.csv", "1,2\n3,4\n   \n")
    mat, ncols = native.parse_csv(p, skip_header=False)
    assert ncols == 2
    np.testing.assert_allclose(mat, [[1, 2], [3, 4]])
    _csv(tmp_path / "tw.csv", "1,2\n\t \n3,4\n")
    mat, ncols = native.parse_csv(p, skip_header=False)
    np.testing.assert_allclose(mat, [[1, 2], [3, 4]])


def test_native_csv_jagged_rows_error(tmp_path):
    p = _csv(tmp_path / "j.csv", "1,2,3\n4,5\n")
    assert native.parse_csv(p, skip_header=False) is None


def test_native_idx_bad_magic(tmp_path):
    p = str(tmp_path / "bad.idx")
    with open(p, "wb") as f:
        f.write(b"\x12\x34\x08\x01" + struct.pack(">I", 3) + b"\x01\x02\x03")
    assert native.read_idx(p) is None


def test_minibatch_stream_mem_and_file(tmp_path):
    X = np.arange(23 * 4, dtype=np.float32).reshape(23, 4)
    with MinibatchStream(X, batch_size=5, seed=7) as s:
        assert s.is_native and s.batches_per_epoch == 5
        seen = []
        for xb, idx in s.epoch():
            np.testing.assert_array_equal(xb, X[idx])
            seen.extend(idx.tolist())
        assert sorted(seen) == list(range(23))
        seen2 = [i for _, idx in s.epoch() for i in idx.tolist()]
        assert sorted(seen2) == list(range(23)) and seen2 != seen
    with MinibatchStream(X, 5, seed=7) as a, MinibatchStream(X, 5, seed=7) as b:
        assert ([i.tolist() for _, i in a.epoch()]
                == [i.tolist() for _, i in b.epoch()])
    p = str(tmp_path / "big.npy")
    Y = np.random.default_rng(0).standard_normal((257, 6)).astype(np.float32)
    np.save(p, Y)
    with MinibatchStream(p, batch_size=64, seed=1) as fs:
        assert fs.is_native
        tot = 0
        for xb, idx in fs.epoch():
            np.testing.assert_array_equal(xb, Y[idx])
            tot += len(idx)
        assert tot == 257


def test_minibatch_stream_numpy_fallback(monkeypatch):
    """Without the native lib MinibatchStream keeps its API over numpy
    gathers (another permutation) and says so in is_native."""
    monkeypatch.setattr(data_stream, "get_lib", lambda: None)
    X = np.arange(11 * 3, dtype=np.float32).reshape(11, 3)
    s = data_stream.MinibatchStream(X, batch_size=4, seed=0)
    assert not s.is_native
    seen = []
    for xb, idx in s.epoch():
        np.testing.assert_array_equal(xb, X[idx])
        seen.extend(idx.tolist())
    assert sorted(seen) == list(range(11))


def test_batch_regressor_native_stream():
    """stream='native' trains through the prefetcher to the quality of the
    default path (the JAX test's data and bound)."""
    from tensornetworksfork_tpu_torch.models.module import TensorTrainBatchRegressor
    rng = np.random.default_rng(5)
    X = rng.uniform(-1, 1, size=(256, 3)).astype(np.float32)
    y = (X[:, :1] * X[:, 1:2] + 0.3 * X[:, 2:]).astype(np.float32)
    kw = dict(N=2, r=4, num_swipes=3, batch_size=64, eps_start=0.5,
              swipe_method="batch_same", seed=0, verbose=0, device="cpu")
    m = TensorTrainBatchRegressor(stream="native", **kw)
    m.fit(X, y, split_train=False)
    m0 = TensorTrainBatchRegressor(**kw)
    m0.fit(X, y, split_train=False)
    assert m.score(X, y) > 0.9 and m0.score(X, y) > 0.9


# --------------------------------------------------------- against the JAX lib
def test_read_idx_matches_jax(tmp_path):
    """The same idx files (1-3 dims, an empty one) read to the same arrays
    by both libraries, and by the port's image loader's reader, which takes
    the native parser first for uncompressed files."""
    from tensornetworksfork_tpu_torch.data import images
    rng = np.random.default_rng(1)
    for k, shape in enumerate([(9,), (4, 28, 28), (3, 5), (0, 2)]):
        arr = rng.integers(0, 256, shape, np.uint8)
        p = str(tmp_path / f"f{k}.idx")
        _write_idx(p, arr)
        got, want = native.read_idx(p), jnative.read_idx(p)
        assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape == shape
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(images._read_idx(p), arr)


def test_read_idx_prefers_native(tmp_path, monkeypatch):
    from tensornetworksfork_tpu_torch.data import images
    arr = np.arange(12, dtype=np.uint8).reshape(3, 4)
    p = str(tmp_path / "n.idx")
    _write_idx(p, arr)
    calls = []
    read = native.read_idx
    monkeypatch.setattr(native, "read_idx", lambda q: calls.append(q) or read(q))
    np.testing.assert_array_equal(images._read_idx(p), arr)
    assert calls == [p]


@pytest.mark.parametrize("text,header", [
    ("a,b,c\n1.5,2,3\n-4,5.25,6\n", True),
    ("1,,3\n,5,\n7,abc,9\n", False),
    ("1,2, \n3,4,\n 5 ,6, 7 \n", False),
    ("1e-3,-2.5E2\n\t \n3,4\n  \n", False),
    ("1,2,3\n4,5\n", False),
])
def test_parse_csv_matches_jax(tmp_path, text, header):
    p = _csv(tmp_path / "m.csv", text)
    got, want = native.parse_csv(p, header), jnative.parse_csv(p, header)
    if want is None:
        assert got is None
        return
    assert got[1] == want[1]
    np.testing.assert_array_equal(got[0], want[0])


def _indices(stream, epochs):
    with stream as s:
        return [[idx.tolist() for _, idx in s.epoch()] for _ in range(epochs)]


@pytest.mark.parametrize("n,batch,seed", [(23, 5, 7), (1000, 64, 0), (257, 257, 3)])
def test_stream_sequence_matches_jax(n, batch, seed):
    """Both native streams, one seed: the same index sequence over two
    epochs, and the same gathered rows."""
    if jnative.get_lib() is None:
        pytest.fail("the JAX package's native library did not build")
    X = np.random.default_rng(seed).standard_normal((n, 3)).astype(np.float32)
    a, b = MinibatchStream(X, batch, seed=seed), JStream(X, batch, seed=seed)
    assert a.is_native and b.is_native
    assert _indices(a, 2) == _indices(b, 2)
    with MinibatchStream(X, batch, seed=seed) as s, JStream(X, batch, seed=seed) as t:
        for (xa, ia), (xb, ib) in zip(s.epoch(), t.epoch()):
            np.testing.assert_array_equal(ia, ib)
            np.testing.assert_array_equal(xa, xb)


def test_stream_file_sequence_matches_jax(tmp_path):
    """The file-backed .npy source: the same sequence and rows as the JAX
    package's stream over the same file."""
    p = str(tmp_path / "rows.npy")
    Y = np.random.default_rng(2).standard_normal((301, 2, 3)).astype(np.float32)
    np.save(p, Y)
    assert _indices(MinibatchStream(p, 50, seed=11), 2) == _indices(JStream(p, 50, seed=11), 2)
    with MinibatchStream(p, 50, seed=11) as s:
        for xb, idx in s.epoch():
            np.testing.assert_array_equal(xb, Y[idx])


@pytest.mark.parametrize("swipe_method", ["batch_unique", "batch_same", "batch_block"])
def test_batch_regressor_native_matches_jax(swipe_method):
    """TensorTrainBatchRegressor(stream="native") in each swipe method from
    the JAX package's initial params: the same minibatches (the streams
    agree index by index), the same trajectory and predictions within
    1e-4 x max|pred|."""
    from tensornetworksfork_tpu.models import module as jm
    from tensornetworksfork_tpu_torch.models import module as tm
    from tensornetworksfork_tpu_torch.utils.convert import params_from_numpy
    rng = np.random.default_rng(4)
    X = rng.standard_normal((256, 3)).astype(np.float32)
    y = (X[:, 0] + X[:, 1] * X[:, 2]).astype(np.float32)
    kw = dict(N=2, r=4, num_swipes=2, batch_size=64, swipe_method=swipe_method,
              perturb=False, constrict_bond=False, eps_start=1e-3, eps_end=1e-3,
              seed=0, stream="native")
    j = jm.TensorTrainBatchRegressor(**kw)
    t = tm.TensorTrainBatchRegressor(**kw, device="cpu")
    j.input_dim = t.input_dim = X.shape[1] + 1
    j._initialize_model()
    t._initialize_model()
    t._model.params = params_from_numpy(
        {k: np.asarray(v) for k, v in j._model.params.items()}, device="cpu")
    j.fit(X, y)
    t.fit(X, y)
    assert [e["epoch"] for e in t.trajectory] == [e["epoch"] for e in j.trajectory] == [1, 2]
    np.testing.assert_allclose([e["val_rmse"] for e in t.trajectory],
                               [e["val_rmse"] for e in j.trajectory], rtol=1e-3)
    got, want = t.predict(X), np.asarray(j.predict(X))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=PRED_REL * np.abs(want).max())


def test_native_stream_raises_without_the_library(monkeypatch, tmp_path):
    """A library that cannot be built: get_lib() is None with g++'s stderr
    in build_error(), MinibatchStream takes its numpy path (is_native
    False), and stream="native" raises with that stderr instead of falling
    back to the numpy permutation."""
    from tensornetworksfork_tpu_torch.models.module import TensorTrainBatchRegressor
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "tnf_native")
    monkeypatch.setattr(native, "GXX_FLAGS", native.GXX_FLAGS + ("-fno-such-option-tnf",))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_error", None)
    assert native.get_lib() is None
    assert "no-such-option-tnf" in native.build_error()
    X = np.random.default_rng(0).standard_normal((64, 3)).astype(np.float32)
    assert not MinibatchStream(X, 16).is_native
    est = TensorTrainBatchRegressor(N=2, r=4, num_swipes=1, batch_size=16,
                                    stream="native", device="cpu")
    with pytest.raises(RuntimeError, match="no-such-option-tnf"):
        est.fit(X, X[:, 0])
