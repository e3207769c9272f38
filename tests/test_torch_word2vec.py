"""Slice 5d's Word2Vec and FeatureHasher in the port against the JAX
package's, on the CPU, on the same seeded inputs.

Tolerances, and why:
- the vocabulary, the skip-gram pairs, the initial vectors and every
  ``default_rng`` draw (the permutation, the wrap-around fill, the
  negatives) are equal: the same host numpy in both packages;
- one ``_sgns_train`` step: the (B, 1+neg) scores and the gradients are
  float32 products summed in another order (a batched matmul in torch, an
  XLA dot), and both scatter-adds sum duplicates in index order on the
  CPU, so the embeddings agree within STEP = 1e-6 of their largest |value|
  (a few ulps);
- the whole fit carries those ulps through every step: each word's
  vector keeps a cosine similarity above COSINE = 1 − 1e-5 to the
  reference's (measured 1 − 2e-7 after 3 epochs), while the control, a fit
  from another seed, falls below 0.5 — and ``find_synonyms``' top terms
  are ``==``;
- FeatureHasher is equal (the same CRC32 host loop).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import clustermachinelearningforhospitalnetworks_apache_spark_tpu as J
import clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch as P
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.features import word2vec as jw
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.features import (
    word2vec as pw,
)

torch.set_num_threads(1)

STEP = 1e-6
COSINE = 1 - 1e-5
CONTROL = 0.5


def _docs(n=300, seed=0):
    """Notes drawn from 4 topics of 12 terms each, 20 tokens a note."""
    rng = np.random.default_rng(seed)
    topics = [[f"t{t}w{i}" for i in range(12)] for t in range(4)]
    return [list(rng.choice(topics[int(rng.integers(4))], 20)) for _ in range(n)]


KW = {"vector_size": 16, "min_count": 2, "batch_size": 256}


def _capture(module, monkeypatch, to_numpy):
    """Record every ``_sgns_train`` call of ``module`` (returning its
    embeddings untouched)."""
    calls = []

    def fake(emb_in, emb_out, centers, contexts, negatives, lr, batch, neg, steps):
        calls.append({k: to_numpy(v) for k, v in (("emb_in", emb_in), ("emb_out", emb_out),
                                                  ("centers", centers),
                                                  ("contexts", contexts),
                                                  ("negatives", negatives))}
                     | {"lr": float(lr), "batch": batch, "neg": neg, "steps": steps})
        return emb_in, emb_out

    monkeypatch.setattr(module, "_sgns_train", fake)
    return calls


@pytest.mark.parametrize("kw", [{"max_iter": 2}, {"max_iter": 1, "window_size": 2,
                                                  "num_negatives": 3, "batch_size": 1000,
                                                  "min_count": 5, "seed": 3}])
def test_vocabulary_pairs_and_draws_equal(kw, monkeypatch):
    docs = _docs()
    kw = {**KW, **kw}
    want = _capture(jw, monkeypatch, lambda a: np.asarray(a))
    got = _capture(pw, monkeypatch, lambda a: a.numpy() if hasattr(a, "numpy") else a)
    jm = J.Word2Vec(**kw).fit(docs)
    pm = P.Word2Vec(**kw).fit(docs, device="cpu")
    assert pm.vocabulary == jm.vocabulary
    assert len(got) == len(want) == kw["max_iter"]
    for g, w in zip(got, want):
        for k in ("emb_in", "emb_out", "centers", "contexts", "negatives"):
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        assert (g["lr"], g["batch"], g["neg"], g["steps"]) == \
            (w["lr"], w["batch"], w["neg"], w["steps"])


@pytest.mark.parametrize("steps", [1, 3])
def test_sgns_steps_within_ulps(steps):
    rng = np.random.default_rng(1)
    v, d, batch, neg = 30, 8, 64, 5
    emb_in = rng.uniform(-0.5, 0.5, size=(v, d)).astype(np.float32)
    emb_out = rng.normal(0, 0.3, size=(v, d)).astype(np.float32)
    # few distinct ids: many duplicates in every scatter
    centers = rng.integers(0, v, steps * batch).astype(np.int32)
    contexts = rng.integers(0, v, steps * batch).astype(np.int32)
    negs = rng.integers(0, v, (steps * batch, neg)).astype(np.int32)
    wi, wo = jw._sgns_train(jnp.asarray(emb_in), jnp.asarray(emb_out), jnp.asarray(centers),
                            jnp.asarray(contexts), jnp.asarray(negs), jnp.float32(0.5),
                            batch, neg, steps)
    gi, go = pw._sgns_train(torch.from_numpy(emb_in.copy()), torch.from_numpy(emb_out.copy()),
                            torch.from_numpy(centers.astype(np.int64)),
                            torch.from_numpy(contexts.astype(np.int64)),
                            torch.from_numpy(negs.astype(np.int64)), 0.5, batch, neg, steps)
    for g, w in ((gi, wi), (go, wo)):
        w = np.asarray(w)
        assert float(np.abs(g.numpy() - w).max()) <= STEP * float(np.abs(w).max())


def _cosines(a, b):
    return (a * b).sum(1) / np.linalg.norm(a, axis=1) / np.linalg.norm(b, axis=1)


@pytest.mark.parametrize("max_iter", [1, 3])
def test_whole_fit_by_cosine_and_synonyms(max_iter):
    docs = _docs()
    kw = {**KW, "max_iter": max_iter}
    jm = J.Word2Vec(**kw).fit(docs)
    pm = P.Word2Vec(**kw).fit(docs, device="cpu")
    control = P.Word2Vec(**{**kw, "seed": 1}).fit(docs, device="cpu")
    assert pm.vocabulary == jm.vocabulary
    assert pm.vectors.dtype == np.float32 and pm.vectors.shape == jm.vectors.shape
    assert float(_cosines(pm.vectors, jm.vectors).min()) >= COSINE
    assert float(_cosines(control.vectors, jm.vectors).min()) < CONTROL
    for word in ("t0w0", "t1w3", "t3w11"):
        assert [t for t, _ in pm.find_synonyms(word, 5)] == \
            [t for t, _ in jm.find_synonyms(word, 5)]
    toks = docs[:7] + [["unknown"], []]
    np.testing.assert_allclose(pm.transform(toks), jm.transform(toks), atol=1e-6)
    assert pm.get_vectors().keys() == jm.get_vectors().keys()


def test_fit_refusals_match_the_reference():
    for kw in ({"vector_size": 0}, {"max_iter": 0}, {"window_size": 0}, {"batch_size": 0},
               {"num_negatives": 0}):
        for pkg, on in ((J, {}), (P, {"device": "cpu"})):
            with pytest.raises(ValueError):
                pkg.Word2Vec(**kw).fit(_docs(5), **on)
    for pkg, on in ((J, {}), (P, {"device": "cpu"})):
        with pytest.raises(ValueError, match="min_count"):
            pkg.Word2Vec(min_count=1000).fit(_docs(5), **on)
        with pytest.raises(KeyError):
            pkg.Word2VecModel(("a",), np.ones((1, 2), np.float32)).find_synonyms("b")


@pytest.mark.parametrize("num_features", [1, 8, 1 << 10])
def test_feature_hasher_equal(num_features):
    rng = np.random.default_rng(2)
    rows = [{"hospital": f"H{int(rng.integers(5))}", "beds": float(rng.integers(0, 40)),
             "icu": bool(rng.integers(2)), "los": float(rng.normal()),
             "missing": None if i % 3 else np.nan} for i in range(40)]
    np.testing.assert_array_equal(P.FeatureHasher(num_features).transform(rows),
                                  J.FeatureHasher(num_features).transform(rows))
    cols = {"hospital_id": np.array([r["hospital"] for r in rows], dtype=object),
            "beds": np.array([r["beds"] for r in rows])}
    np.testing.assert_array_equal(
        P.FeatureHasher(num_features).transform(P.Table.from_dict(cols)),
        J.FeatureHasher(num_features).transform(J.Table.from_dict(cols)))
    for pkg in (J, P):
        with pytest.raises(TypeError, match="dicts"):
            pkg.FeatureHasher(num_features).transform([[1, 2]])
