"""Slice 5d's text stages in the port against the JAX package's, on the
CPU, on the same seeded inputs.

Tolerances, and why:
- Tokenizer, RegexTokenizer, StopWordsRemover, NGram, CountVectorizer,
  HashingTF and IDF's fit are equal: the same host Python / numpy in both
  packages (CRC32 hashing, a float64 df count);
- IDFModel.transform is equal on an ndarray (the same numpy) and on a
  tensor (one float32 product per element in both);
- DCT: the port multiplies by the orthonormal DCT matrix (float64 cast to
  float32), the JAX package runs ``jax.scipy.fft.dct`` (an FFT in
  float32): both round d float32 terms a row, so they agree within
  DCT_TOL = 2e-6 of the row's largest |x| at d ≤ 64 (measured 4.7e-7), and
  the round trip DCT-III(DCT-II(x)) returns x within the same bound.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import clustermachinelearningforhospitalnetworks_apache_spark_tpu as J
import clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch as P

torch.set_num_threads(1)

DCT_TOL = 2e-6

_WORDS = ("patient admitted ER triage ICU ward discharge Fever cough sepsis the a and of "
          "to in was with The AND 72h follow-up note: no-show").split()


def _texts(n=60, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        k = int(rng.integers(0, 14))
        out.append("  ".join(" ".join(rng.choice(_WORDS, k)).split(" ")))
    out[3] = ""
    return np.asarray(out, dtype=object)


def _same_rows(got, want):
    assert len(got) == len(want)
    assert [list(r) for r in got] == [list(r) for r in want]


@pytest.mark.parametrize("seed", [0, 1])
def test_tokenizers_equal(seed):
    texts = _texts(seed=seed)
    _same_rows(P.Tokenizer().transform(texts), J.Tokenizer().transform(texts))
    for kw in ({}, {"gaps": False, "pattern": r"\w+"}, {"min_token_length": 3},
               {"to_lowercase": False, "pattern": r"[\s:-]+"}):
        _same_rows(P.RegexTokenizer(**kw).transform(texts),
                   J.RegexTokenizer(**kw).transform(texts))


@pytest.mark.parametrize("case_sensitive", [False, True])
def test_stop_words_and_ngrams_equal(case_sensitive):
    toks = J.RegexTokenizer(to_lowercase=False).transform(_texts())
    for stop in ((), ("The", "was", "ICU")):
        kw = {"case_sensitive": case_sensitive, **({"stop_words": stop} if stop else {})}
        _same_rows(P.StopWordsRemover(**kw).transform(toks),
                   J.StopWordsRemover(**kw).transform(toks))
    for n in (1, 2, 3):
        _same_rows(P.NGram(n).transform(toks), J.NGram(n).transform(toks))
    for pkg in (J, P):
        with pytest.raises(TypeError, match="token lists"):
            pkg.NGram(2).transform(["raw text"])
        with pytest.raises(ValueError, match="n must be"):
            pkg.NGram(0)


@pytest.mark.parametrize("kw", [{}, {"min_df": 2.0}, {"min_df": 0.1}, {"vocab_size": 5},
                                {"min_tf": 2.0}, {"min_tf": 0.2}, {"binary": True}])
def test_count_vectorizer_equal(kw):
    toks = J.Tokenizer().transform(_texts(80, seed=2))
    jm, pm = J.CountVectorizer(**kw).fit(toks), P.CountVectorizer(**kw).fit(toks)
    assert pm._artifacts() == jm._artifacts()
    np.testing.assert_array_equal(pm.transform(toks), jm.transform(toks))
    np.testing.assert_array_equal(P.CountVectorizer(**kw).fit_transform(toks),
                                  J.CountVectorizer(**kw).fit_transform(toks))


@pytest.mark.parametrize("binary", [False, True])
@pytest.mark.parametrize("num_features", [1, 16, 1 << 12])
def test_hashing_tf_equal(num_features, binary):
    toks = J.Tokenizer().transform(_texts(50, seed=3))
    jm, pm = J.HashingTF(num_features, binary), P.HashingTF(num_features, binary)
    np.testing.assert_array_equal(pm.indices_of(_WORDS), jm.indices_of(_WORDS))
    np.testing.assert_array_equal(pm.transform(toks), jm.transform(toks))


def test_hashing_tf_refuses_the_same_budget():
    rows = [["a"]] * 5
    for pkg in (J, P):
        with pytest.raises(ValueError, match="element budget"):
            pkg.HashingTF(1 << 27).transform(rows)


@pytest.mark.parametrize("min_doc_freq", [0, 3])
def test_idf_equal_on_ndarray_and_tensor(min_doc_freq):
    toks = J.Tokenizer().transform(_texts(90, seed=4))
    tf = J.CountVectorizer().fit(toks).transform(toks)
    jm = J.IDF(min_doc_freq).fit(tf)
    for src in (tf, torch.from_numpy(tf)):
        pm = P.IDF(min_doc_freq).fit(src)
        np.testing.assert_array_equal(pm.idf, jm.idf)
    want = np.asarray(jm.transform(tf))
    got = pm.transform(tf)
    assert isinstance(got, np.ndarray)
    np.testing.assert_array_equal(got, want)
    t = pm.transform(torch.from_numpy(tf))
    assert isinstance(t, torch.Tensor) and t.dtype == torch.float32
    np.testing.assert_array_equal(t.numpy(), np.asarray(jm.transform(jnp.asarray(tf))))
    # integer counts promote to float32 on both containers
    ti = tf.astype(np.int64)
    np.testing.assert_array_equal(pm.transform(ti), np.asarray(jm.transform(ti)))
    np.testing.assert_array_equal(pm.transform(torch.from_numpy(ti)).numpy(),
                                  np.asarray(jm.transform(jnp.asarray(ti))))
    np.testing.assert_array_equal(P.IDF(min_doc_freq).fit_transform(tf),
                                  np.asarray(J.IDF(min_doc_freq).fit_transform(tf)))


@pytest.mark.parametrize("d", [1, 2, 4, 7, 64])
@pytest.mark.parametrize("inverse", [False, True])
def test_dct_against_jax_scipy_fft(d, inverse):
    rng = np.random.default_rng(d)
    x = (rng.normal(size=(33, d)) * rng.uniform(0.1, 100, size=(33, 1))).astype(np.float32)
    want = np.asarray(J.DCT(inverse).transform(x))
    for src in (x, torch.from_numpy(x)):
        got = P.DCT(inverse).transform(src, device="cpu")
        assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
        scale = np.abs(x).max(axis=1, keepdims=True)
        assert float((np.abs(got.numpy() - want) / scale).max()) <= DCT_TOL
    # the round trip
    back = P.DCT(not inverse).transform(P.DCT(inverse).transform(x, device="cpu"))
    assert float((np.abs(back.numpy() - x) / np.abs(x).max(axis=1, keepdims=True)).max()) \
        <= DCT_TOL


def test_dct_keeps_a_tensor_where_it_lies_and_counts_integer_rows():
    x = np.arange(12, dtype=np.int64).reshape(3, 4)
    got = P.DCT().transform(torch.from_numpy(x))
    assert got.device.type == "cpu" and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(J.DCT().transform(x)),
                               atol=DCT_TOL * 11)
    with pytest.raises(ValueError, match=r"\(n, d\)"):
        P.DCT().transform(np.ones(3), device="cpu")
