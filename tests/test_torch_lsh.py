"""Slice 5d's LSH families in the port against the JAX package's, on the
CPU, on the same seeded numpy inputs.

Everything is equal (``==``): both packages hash, merge candidates and
verify distances in the same host numpy, from the same ``default_rng``
draws — the float64 projections and the int64 MinHash residues included,
so float64 features of magnitude 1e8 land in the same buckets too.
"""

import numpy as np
import pytest

import clustermachinelearningforhospitalnetworks_apache_spark_tpu as J
import clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch as P


def _points(n=300, d=5, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 10, size=(6, d))
    return (centers[rng.integers(0, 6, n)] + rng.normal(0, 1, (n, d))) * scale


def _sets(n=200, d=40, seed=1):
    rng = np.random.default_rng(seed)
    x = (rng.random((n, d)) < 0.15).astype(np.float64)
    x[np.arange(n), rng.integers(0, d, n)] = 1.0        # no empty set
    x[n // 2:] = x[: n - n // 2]                        # duplicates collide
    return x


def _models(family: str, data, **kw):
    if family == "brp":
        kw = {"bucket_length": 2.0, "num_hash_tables": 3, "seed": 7, **kw}
        return (J.BucketedRandomProjectionLSH(**kw).fit(data),
                P.BucketedRandomProjectionLSH(**kw).fit(data))
    kw = {"num_hash_tables": 4, "seed": 7, **kw}
    return J.MinHashLSH(**kw).fit(data), P.MinHashLSH(**kw).fit(data)


def _data(family: str):
    return _points() if family == "brp" else _sets()


def _assert_tuples_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("family", ["brp", "minhash"])
def test_hashes_are_the_reference_hashes(family):
    x = _data(family)
    jm, pm = _models(family, x)
    assert pm._artifacts()[1] == jm._artifacts()[1]
    for k, v in jm._artifacts()[2].items():
        np.testing.assert_array_equal(pm._artifacts()[2][k], v)
    np.testing.assert_array_equal(pm.hash_matrix(x), jm.hash_matrix(x))
    np.testing.assert_array_equal(pm.transform(x), jm.transform(x))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_candidate_pairs_equal(seed):
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu.features import lsh as jl
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.features import (
        lsh as pl,
    )

    rng = np.random.default_rng(seed)
    ha = rng.integers(0, 6, size=(50, 3))
    hb = rng.integers(0, 6, size=(40, 3))
    _assert_tuples_equal(pl._candidate_pairs(ha, hb), jl._candidate_pairs(ha, hb))
    _assert_tuples_equal(pl._candidate_pairs(ha, hb + 100), jl._candidate_pairs(ha, hb + 100))


@pytest.mark.parametrize("k", [1, 5, 50])
@pytest.mark.parametrize("family", ["brp", "minhash"])
def test_nearest_neighbours_equal(family, k):
    x = _data(family)
    jm, pm = _models(family, x)
    for key in (x[3], x[17] + (0.3 if family == "brp" else 0.0)):
        _assert_tuples_equal(pm.approx_nearest_neighbors(x, key, k),
                             jm.approx_nearest_neighbors(x, key, k))
        np.testing.assert_array_equal(
            pm.approx_nearest_neighbors(x, key, k, return_distances=False),
            jm.approx_nearest_neighbors(x, key, k, return_distances=False))


@pytest.mark.parametrize("threshold", [0.0, 0.5, 3.0])
@pytest.mark.parametrize("family", ["brp", "minhash"])
def test_similarity_join_equal(family, threshold):
    x = _data(family)
    jm, pm = _models(family, x)
    a, b = x[: len(x) // 2], x[len(x) // 3:]
    _assert_tuples_equal(pm.approx_similarity_join(a, b, threshold),
                         jm.approx_similarity_join(a, b, threshold))


def test_large_magnitude_float64_buckets_stay_exact():
    """Features of magnitude 1e8 (float32 ULP 8 > bucket_length 0.5): the
    float64 hash keeps neighbours apart exactly as the reference does."""
    x = _points(200, 4, seed=3) + 1e8
    jm, pm = _models("brp", x, bucket_length=0.5)
    h = pm.hash_matrix(x)
    np.testing.assert_array_equal(h, jm.hash_matrix(x))
    # distinct rows stay in distinct buckets far more often than float32 allows
    assert len({tuple(r) for r in h}) > 150
    _assert_tuples_equal(pm.approx_similarity_join(x, x, 1.0),
                         jm.approx_similarity_join(x, x, 1.0))
    _assert_tuples_equal(pm.approx_nearest_neighbors(x, x[5], 3),
                         jm.approx_nearest_neighbors(x, x[5], 3))


def test_assembled_table_transform_appends_hash_columns():
    x = _points(120, 3, seed=4)
    cols = {"a": x[:, 0], "b": x[:, 1], "c": x[:, 2]}
    ja = J.VectorAssembler(["a", "b", "c"]).transform(J.Table.from_dict(cols))
    pa = P.VectorAssembler(["a", "b", "c"]).transform(P.Table.from_dict(cols))
    jm, pm = _models("brp", x)
    got, want = pm.transform(pa), jm.transform(ja)
    assert list(got.table.columns) == list(want.table.columns)
    for c in want.table.columns:
        np.testing.assert_array_equal(got.table.column(c), want.table.column(c))
    np.testing.assert_array_equal(got.features, want.features)


@pytest.mark.parametrize("family", ["brp", "minhash"])
def test_refusals_match_the_reference(family):
    x = _data(family)
    jm, pm = _models(family, x)
    for m in (jm, pm):
        with pytest.raises(ValueError, match="k must be"):
            m.approx_nearest_neighbors(x, x[0], 0)
        with pytest.raises(ValueError, match="threshold"):
            m.approx_similarity_join(x, x, -1.0)
        with pytest.raises(ValueError, match="features"):
            m.approx_nearest_neighbors(x, x[0, :2], 1)
    if family == "minhash":
        bad = x.copy()
        bad[0] = 0.0
        for m in (jm, pm):
            with pytest.raises(ValueError, match="non-zero"):
                m.hash_matrix(bad)
    else:
        for pkg in (J, P):
            with pytest.raises(ValueError, match="bucket_length"):
                pkg.BucketedRandomProjectionLSH().fit(x)
