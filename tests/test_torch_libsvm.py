"""LIBSVM files across the two packages, on the CPU: a file written by
either package reads the same in the other, and a hand-written file (and
each malformed one) reads the same in both.  Host work in both packages,
so every array is equal and every error is the same."""

import numpy as np
import pytest

import clustermachinelearningforhospitalnetworks_apache_spark_tpu as J
import clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch as P


def _rows(n=60, d=7, seed=2):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    x[rng.random((n, d)) < 0.6] = 0.0           # sparse, as LIBSVM files are
    x[3] = 0.0                                   # a row with no feature
    y = rng.integers(0, 3, n).astype(np.float32)
    y[5] = 1.0 / 3.0                             # a label with 9 significant digits
    return x, y


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_file_written_by_one_package_reads_the_same_in_the_other(writer, tmp_path):
    x, y = _rows()
    path = str(tmp_path / "d.libsvm")
    (J if writer == "jax" else P).write_libsvm(path, x, y)
    for m in (J, P):
        gx, gy = m.read_libsvm(path, n_features=x.shape[1])
        np.testing.assert_array_equal(gx, x)
        np.testing.assert_array_equal(gy, y)
    other = str(tmp_path / "e.libsvm")
    (P if writer == "jax" else J).write_libsvm(other, x, y)
    assert open(path).read() == open(other).read()


@pytest.mark.parametrize("zero_based", [False, True])
@pytest.mark.parametrize("n_features", [None, 12])
def test_hand_written_file_reads_the_same(zero_based, n_features, tmp_path):
    path = tmp_path / "h.txt"
    path.write_text("1 1:0.5 3:2 # a comment\n\n-1 2:1e-3 4:7\n0\n2.5 1:-1 2:2 3:3 4:4 5:5\n")
    jx, jy = J.read_libsvm(str(path), n_features=n_features, zero_based=zero_based)
    px, py = P.read_libsvm(str(path), n_features=n_features, zero_based=zero_based)
    assert px.dtype == jx.dtype == np.float32 and px.shape == jx.shape
    np.testing.assert_array_equal(px, jx)
    np.testing.assert_array_equal(py, jy)


@pytest.mark.parametrize("text,kw", [
    ("x 1:2\n", {}),
    ("1 1-2\n", {}),
    ("1 0:2\n", {}),
    ("1 2:1 1:1\n", {}),
    ("1 2:1 2:3\n", {}),
    ("1 9:1\n", {"n_features": 4}),
    ("1 -1:3\n", {"zero_based": True}),
])
def test_malformed_files_raise_the_same(text, kw, tmp_path):
    path = tmp_path / "bad.txt"
    path.write_text(text)
    with pytest.raises(ValueError) as want:
        J.read_libsvm(str(path), **kw)
    with pytest.raises(ValueError) as got:
        P.read_libsvm(str(path), **kw)
    assert str(got.value) == str(want.value)


def test_write_refuses_mismatched_rows(tmp_path):
    for m in (J, P):
        with pytest.raises(ValueError, match="rows mismatch"):
            m.write_libsvm(str(tmp_path / "m.txt"), np.zeros((3, 2)), np.zeros(4))
