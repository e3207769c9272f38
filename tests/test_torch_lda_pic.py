"""Slice 5e's LDA and PowerIterationClustering in the port against the JAX
package's, on the CPU, on the same seeded inputs.

Tolerances, and why:
- LDA's E-step from the same λ: ``torch.special.digamma`` and jax's
  differ by a few ulps, and 50 fixed-point sweeps of float32 products
  follow; γ and the statistics agree within ESTEP = 2e-5 of their largest
  value (measured below 2e-6);
- a fit (20 steps, Spark's defaults): λ within LAM = 5e-5 of the largest
  λ (measured 4.6e-6 after one step, 3e-7 after 20, resident and out of
  core), while the control — a fit from another seed — sits above 0.5;
  the top 5 terms of every topic ``==``; the topic mixtures within
  MIX = 1e-6 and the perplexity bound within PERP = 2e-6 relative
  (measured 4e-9 and 1.8e-7);
- PIC's affinity is equal (the same host ``np.add.at``); the embedding
  (20 matrix-vector products, float32 sums in another order) within
  EMB = 2e-6 of its largest entry (measured 3.6e-7); the partitions equal
  up to a relabelling (the 1-D KMeans starts from the same k-means++
  draws on the same rows).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import clustermachinelearningforhospitalnetworks_apache_spark_tpu as J
import clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch as P
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.models import lda as jlda
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.models import pic as jpic
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.models import lda as plda
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.models import pic as ppic

torch.set_num_threads(1)

ESTEP = 2e-5
LAM = 5e-5
MIX = 1e-6
PERP = 2e-6
EMB = 2e-6


def _topic_docs(seed=0, v=30, k=3, n=300, doc_len=60):
    rng = np.random.default_rng(seed)
    topics = np.zeros((k, v))
    span = v // k
    for j in range(k):
        topics[j, j * span: (j + 1) * span] = 1.0 / span
    docs = np.zeros((n, v), np.float32)
    for i, z in enumerate(rng.integers(0, k, n)):
        np.add.at(docs[i], rng.choice(v, size=doc_len, p=topics[z]), 1.0)
    return docs


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("sweeps", [1, 50])
def test_e_step_within_ulps(sweeps):
    x = _topic_docs(1)[:100]
    lam = np.random.default_rng(2).gamma(100.0, 0.01, size=(3, x.shape[1])).astype(np.float32)
    w = np.ones(len(x), np.float32)
    w[::9] = 0.0
    eb = np.array(jnp.exp(jlda._dirichlet_expectation(jnp.asarray(lam))))
    peb = torch.exp(plda._dirichlet_expectation(torch.from_numpy(lam)))
    assert _rel(peb.numpy(), eb) <= ESTEP
    wg, ws = jlda._e_step(jnp.asarray(x), jnp.asarray(w), jnp.asarray(eb), jnp.float32(1 / 3),
                          sweeps)
    gg, gs = plda._e_step(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(eb),
                          float(np.float32(1 / 3)), sweeps)
    assert _rel(gg.numpy(), wg) <= ESTEP
    assert _rel(gs.numpy(), ws) <= ESTEP


def _top_terms(m, n=5):
    return [list(idx[:n]) for idx, _ in m.describe_topics(n)]


@pytest.mark.parametrize("max_iter", [1, 20])
def test_resident_fit_transform_and_perplexity(max_iter):
    x = _topic_docs()
    jm = J.LDA(k=3, max_iter=max_iter, seed=0).fit(x)
    pm = P.LDA(k=3, max_iter=max_iter, seed=0).fit(x, device="cpu")
    ctl = P.LDA(k=3, max_iter=max_iter, seed=1).fit(x, device="cpu")
    assert pm.lam.dtype == np.float32
    assert _rel(pm.lam, jm.lam) <= LAM
    assert _rel(ctl.lam, jm.lam) > 0.5
    assert _top_terms(pm) == _top_terms(jm)
    assert (pm.alpha, pm.eta, pm.n_docs_trained) == (jm.alpha, jm.eta, jm.n_docs_trained)
    np.testing.assert_allclose(pm.topics_matrix(), jm.topics_matrix(), atol=LAM)
    for src in (x[:50], torch.from_numpy(x[:50])):
        got = pm.transform(src, device="cpu")
        assert float(np.abs(got - jm.transform(x[:50])).max()) <= MIX
    assert abs(pm.log_perplexity(x, device="cpu") / jm.log_perplexity(x) - 1.0) <= PERP
    # the same model in both packages infers the same mixtures
    carried = P.lda_model_from_jax_arrays(jm.lam, alpha=jm.alpha, eta=jm.eta)
    assert float(np.abs(carried.transform(x, device="cpu") - jm.transform(x)).max()) <= MIX


def test_fit_on_a_dataset_and_a_tensor_equals_the_matrix_fit():
    x = _topic_docs(3, n=120)
    a = P.LDA(k=3, max_iter=3).fit(x, device="cpu")
    b = P.LDA(k=3, max_iter=3).fit(torch.from_numpy(x))
    c = P.LDA(k=3, max_iter=3).fit(P.device_dataset(x, device="cpu"))
    np.testing.assert_array_equal(a.lam, b.lam)
    np.testing.assert_array_equal(a.lam, c.lam)


@pytest.mark.parametrize("max_iter,block", [(7, 64), (12, 64), (5, 300)])
def test_outofcore_fit_equals_the_reference(max_iter, block):
    x = _topic_docs(4)
    jm = J.LDA(k=3, max_iter=max_iter, seed=0).fit(J.HostDataset(x=x, max_device_rows=block))
    pm = P.LDA(k=3, max_iter=max_iter, seed=0).fit(P.HostDataset(x=x, max_device_rows=block),
                                                   device="cpu")
    assert _rel(pm.lam, jm.lam) <= LAM
    assert _top_terms(pm) == _top_terms(jm)
    assert pm.n_docs_trained == jm.n_docs_trained


def test_lda_refusals_match_the_reference():
    for pkg, on in ((J, {}), (P, {"device": "cpu"})):
        with pytest.raises(ValueError, match="non-negative"):
            pkg.LDA(k=2).fit(-np.ones((8, 4), np.float32), **on)
        with pytest.raises(ValueError, match="non-negative"):
            pkg.LDA(k=2).fit(pkg.HostDataset(x=-np.ones((8, 4), np.float32)), **on)
        with pytest.raises(ValueError, match="k must be"):
            pkg.LDA(k=1).fit(np.ones((8, 4), np.float32), **on)
        with pytest.raises(ValueError, match="optimizer"):
            pkg.LDA(optimizer="em").fit(np.ones((8, 4), np.float32), **on)
    m = P.LDA(k=2, max_iter=1).fit(np.ones((8, 4), np.float32), device="cpu")
    with pytest.raises(ValueError, match="trained on 4 features"):
        m.transform(np.ones((2, 5), np.float32), device="cpu")


def _knn_graph(n=400, k=8, seed=0, c=4):
    """A k-nearest-neighbour graph of c Gaussian blobs, Gaussian weights
    with σ the median neighbour distance."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 4, (c, 3))[rng.integers(0, c, n)] + rng.normal(size=(n, 3))
    d2 = ((x[:, None] - x[None]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    src = np.repeat(np.arange(n), k)
    dst = np.argsort(d2, 1)[:, :k].ravel()
    dist = np.sqrt(d2[src, dst])
    return src, dst, np.exp(-dist ** 2 / (2 * np.median(dist) ** 2))


def test_affinity_equal_and_self_loops_fold_once():
    src, dst, w = _knn_graph(60)
    src = np.r_[src, 5, 7]
    dst = np.r_[dst, 5, 3]
    w = np.r_[w, 2.0, 0.5].astype(np.float32)
    np.testing.assert_array_equal(ppic._build_affinity(src, dst, w, 60),
                                  jpic._build_affinity(src, dst, w, 60))


def _same_partition(a, b) -> bool:
    pairs = set(zip(a.tolist(), b.tolist()))
    return len(pairs) == len(set(a.tolist())) == len(set(b.tolist()))


@pytest.mark.parametrize("init_mode", ["random", "degree"])
@pytest.mark.parametrize("seed", [0, 1])
def test_pic_embedding_and_partitions(init_mode, seed):
    src, dst, w = _knn_graph(seed=seed)
    est = {"k": 4, "max_iter": 20, "init_mode": init_mode, "seed": seed}
    want = J.PowerIterationClustering(**est).assign_clusters(src, dst, w)
    got = P.PowerIterationClustering(**est).assign_clusters(src, dst, w, device="cpu")
    assert got.dtype == np.int64 and got.shape == want.shape
    assert _same_partition(got, np.asarray(want))
    # the embedding, against the reference's power iteration on the same
    # affinity and start
    n = int(max(src.max(), dst.max())) + 1
    a = jpic._build_affinity(src, dst, w.astype(np.float32), n)
    deg = a.sum(axis=1)
    if init_mode == "degree":
        v0 = deg / deg.sum()
    else:
        v0 = np.random.default_rng(seed).uniform(0, 1, size=n)
        v0 = v0 / np.abs(v0).sum()
    ref = np.asarray(jpic._power_iterate(jnp.asarray(a / deg[:, None]),
                                         jnp.asarray(v0, jnp.float32), 20))
    emb = P.PowerIterationClustering(**est).embed(src, dst, w, device="cpu")
    assert _rel(emb, ref) <= EMB


def test_pic_refusals_match_the_reference():
    src, dst = np.array([0, 1]), np.array([1, 2])
    for pkg, on in ((J, {}), (P, {"device": "cpu"})):
        for est, args, msg in ((pkg.PowerIterationClustering(k=1), (src, dst), "k must be"),
                               (pkg.PowerIterationClustering(init_mode="ones"), (src, dst),
                                "init_mode"),
                               (pkg.PowerIterationClustering(), (src, dst[:1]), "equal-length"),
                               (pkg.PowerIterationClustering(), (np.array([0, 4]), dst),
                                "no edges"),
                               (pkg.PowerIterationClustering(), (src, dst, [1.0, -1.0]),
                                "non-negative"),
                               (pkg.PowerIterationClustering(), (np.array([0]),
                                                                 np.array([40_000])),
                                "budget")):
            with pytest.raises(ValueError, match=msg):
                est.assign_clusters(*args, **on)
