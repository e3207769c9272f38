"""The port's fit checkpointer, on the CPU: the JAX package's layout, so a
checkpoint either package wrote resumes in the other.

A fit preempted between commits (``on_iteration`` / ``on_level``
raising, or an injected crash at a ``fit_ckpt.*`` fault site) resumes
from the last commit and finishes with the uninterrupted fit's result.

Tolerances, and why:
- bit-equal KMeans centers and tree splits: integer-valued rows and
  labels keep every float32 sum exact, so the resumed trajectory (in
  either package) is the uninterrupted one bit for bit;
- a resumed fit within the same package is compared exactly (same code,
  same data, same order), GaussianMixture included;
- a cross-package KMeans ``training_cost`` at rtol 1e-5: float32 sums of
  the rows' distances in another order (``test_torch_outofcore.py``).
"""

import json
import os

import numpy as np
import pytest
import torch

import clustermachinelearningforhospitalnetworks_apache_spark_tpu as J
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.io import (
    fit_checkpoint as jfc,
)
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.models.tree import (
    engine as jeng,
)
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.parallel.outofcore import (
    HostDataset as JHostDataset,
)
import clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch as P
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.io import (
    fit_checkpoint as pfc,
)
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.models.tree import (
    engine as peng,
)
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.utils import (
    faults as p_faults,
)

torch.set_num_threads(1)


class Preempt(RuntimeError):
    pass


def _bomb_at(n):
    def hook(it, *rest):
        if it == n:
            raise Preempt()
    return hook


def _int_blobs(n=2048, d=4, k=4, seed=7):
    rng = np.random.default_rng(seed)
    centers = rng.integers(-40, 40, size=(k, d))
    return (centers[rng.integers(0, k, size=n)]
            + rng.integers(-9, 10, size=(n, d))).astype(np.float32)


def _tree_data(n=2000, d=5, seed=0):
    rng = np.random.default_rng(seed)
    x = np.round(rng.normal(size=(n, d)) * 4).astype(np.float32)
    y = np.round(x @ rng.normal(size=(d,)) + rng.normal(0, 0.3, size=n)).astype(np.float32)
    return x, y


# ----------------------------------------------------------- the checkpointer
def test_roundtrip_and_prune(tmp_path):
    ck = P.FitCheckpointer(str(tmp_path / "ck"), {"a": 1}, keep=2)
    assert ck.resume() is None
    for step in (2, 4, 6):
        ck.save(step, {"x": np.full((3,), step), "t": torch.arange(step)},
                extra={"ll": step * 1.5})
    step, arrays, extra = ck.resume()
    assert step == 6 and extra == {"ll": 9.0}
    np.testing.assert_array_equal(arrays["x"], np.full((3,), 6))
    np.testing.assert_array_equal(arrays["t"], np.arange(6))
    assert sorted(ck._step_dirs()) == [4, 6]
    ck.clear()
    assert not os.path.exists(ck.path)


def test_signature_mismatch_raises(tmp_path):
    path = str(tmp_path / "ck")
    P.FitCheckpointer(path, {"k": 4}).save(1, {"x": np.zeros(2)})
    with pytest.raises(ValueError, match="signature mismatch"):
        P.FitCheckpointer(path, {"k": 5}).resume()


def test_torn_save_is_invisible(tmp_path):
    path = str(tmp_path / "ck")
    P.FitCheckpointer(path, {"k": 4}).save(3, {"x": np.ones(2)})
    os.makedirs(os.path.join(path, ".tmp-step-6"))       # staged, never renamed
    step, arrays, _ = P.FitCheckpointer(path, {"k": 4}).resume()
    assert step == 3 and not os.path.exists(os.path.join(path, ".tmp-step-6"))
    np.testing.assert_array_equal(arrays["x"], np.ones(2))


def test_resave_crash_window_and_orphans_recover(tmp_path):
    path = str(tmp_path / "ck")
    ck = P.FitCheckpointer(path, {"k": 4}, keep=2)
    ck.save(1, {"x": np.full((2,), 1.0)})
    ck.save(3, {"x": np.ones(2)})
    # a re-save of step 3 displaced the committed dir and died
    os.replace(os.path.join(path, "step-3"), os.path.join(path, ".old-step-3"))
    step, _, _ = P.FitCheckpointer(path, {"k": 4}).resume()
    assert step == 3
    # an orphan newer than COMMIT is neither counted toward keep nor kept
    os.makedirs(os.path.join(path, "step-9"))
    ck.save(4, {"x": np.full((2,), 4.0)})
    assert sorted(ck._step_dirs()) == [3, 4]


@pytest.mark.parametrize("site", ["fit_ckpt.save.arrays", "fit_ckpt.save.commit"])
def test_crash_inside_a_save_leaves_the_previous_commit(site, tmp_path, monkeypatch):
    monkeypatch.setenv("CMLHN_FLIGHT_DIR", str(tmp_path / "flight"))
    path = str(tmp_path / "ck")
    P.FitCheckpointer(path, {"k": 4}).save(2, {"x": np.full((2,), 2.0)})
    with p_faults.active(p_faults.FaultPlan().crash(site)):
        with pytest.raises(p_faults.InjectedCrash):
            P.FitCheckpointer(path, {"k": 4}).save(4, {"x": np.full((2,), 4.0)})
    step, arrays, _ = P.FitCheckpointer(path, {"k": 4}).resume()
    assert step == 2
    np.testing.assert_array_equal(arrays["x"], np.full((2,), 2.0))


def test_corrupt_commit_falls_back_to_an_older_step(tmp_path, monkeypatch):
    path = str(tmp_path / "ck")
    ck = P.FitCheckpointer(path, {"k": 4}, keep=2)
    ck.save(1, {"x": np.full((2,), 1.0)})
    with p_faults.active(p_faults.FaultPlan().corrupt("fit_ckpt.save.arrays", at_byte=80)):
        ck.save(2, {"x": np.full((2,), 2.0)})
    step, arrays, _ = ck.resume()
    assert step == 1
    np.testing.assert_array_equal(arrays["x"], np.full((2,), 1.0))
    ck2 = P.FitCheckpointer(str(tmp_path / "one"), {"k": 4}, keep=1)
    with p_faults.active(p_faults.FaultPlan().corrupt("fit_ckpt.save.arrays", at_byte=80)):
        ck2.save(1, {"x": np.zeros(2)})
    with pytest.raises(P.CorruptArtifactError):
        ck2.resume()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_either_package_reads_the_others_checkpoint_files(writer, tmp_path):
    path = str(tmp_path / "ck")
    sig = {"estimator": "KMeans", "k": 3, "tol": 0.0001, "warm": None}
    mods = (jfc, pfc) if writer == "jax" else (pfc, jfc)
    w = mods[0].FitCheckpointer(path, sig)
    w.save(5, {"centers": np.arange(6, dtype=np.float32).reshape(3, 2)},
           extra={"prev_ll": -1.5})
    step, arrays, extra = mods[1].FitCheckpointer(path, sig).resume()
    assert step == 5 and extra == {"prev_ll": -1.5}
    np.testing.assert_array_equal(arrays["centers"], np.arange(6).reshape(3, 2))
    with open(os.path.join(path, "COMMIT")) as f:
        assert json.load(f) == {"step": 5, "signature": sig}


@pytest.mark.parametrize("w", [None, "weights"])
@pytest.mark.parametrize("kind", ["numpy", "memmap", "tensor"])
def test_fingerprints_hash_the_jax_packages_bytes(kind, w, tmp_path):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3000, 4)).astype(np.float32)
    wv = rng.uniform(size=3000).astype(np.float32) if w else None
    want = jfc.data_fingerprint(x, wv)
    if kind == "memmap":
        np.save(tmp_path / "x.npy", x)
        x = np.load(tmp_path / "x.npy", mmap_mode="r")
    if kind == "tensor":
        x = torch.from_numpy(x)
        wv = None if wv is None else torch.from_numpy(wv)
    assert pfc.data_fingerprint(x, wv) == want
    assert pfc.array_fingerprint(x) == jfc.array_fingerprint(np.asarray(x))
    assert pfc.data_fingerprint(x[:0]) == jfc.data_fingerprint(np.asarray(x[:0]))


# ---------------------------------------------- preempt and resume, port only
@pytest.mark.parametrize("outofcore", [False, True])
def test_kmeans_preempt_resume_exact(outofcore, tmp_path):
    x = _int_blobs()
    data = P.HostDataset(x=x, max_device_rows=512) if outofcore else x
    base = dict(k=4, seed=0, max_iter=20, tol=0.0)
    full = P.KMeans(**base).fit(data, device="cpu", on_iteration=lambda *a: None)
    est = P.KMeans(checkpoint_dir=str(tmp_path / "km"), checkpoint_every=1, **base)
    with pytest.raises(Preempt):
        est.fit(data, device="cpu", on_iteration=_bomb_at(2))
    seen = []
    resumed = est.fit(data, device="cpu", on_iteration=lambda it, c, m: seen.append(it))
    assert seen[0] == 3
    np.testing.assert_array_equal(resumed.cluster_centers, full.cluster_centers)
    assert resumed.training_cost == full.training_cost
    assert full.n_iter <= resumed.n_iter <= full.n_iter + 1
    # a finished fit resumes at its last commit and returns the same model
    again = est.fit(data, device="cpu")
    np.testing.assert_array_equal(again.cluster_centers, resumed.cluster_centers)


def test_kmeans_checkpoint_refuses_other_data_warm_start_and_storage(tmp_path):
    x = _int_blobs(512, 3, 2, seed=1)
    ck = str(tmp_path / "km")
    est = P.KMeans(k=2, seed=0, max_iter=3, checkpoint_dir=ck, checkpoint_every=1)
    est.fit(P.HostDataset(x=x, max_device_rows=128), device="cpu")
    for other in (P.HostDataset(x=_int_blobs(512, 3, 2, seed=2), max_device_rows=128), x):
        with pytest.raises(ValueError, match="signature mismatch"):
            est.fit(other, device="cpu")
    warm = P.KMeans(k=2, seed=0, max_iter=3, checkpoint_dir=ck, checkpoint_every=1,
                    warm_start_centers=x[:2])
    with pytest.raises(ValueError, match="signature mismatch"):
        warm.fit(P.HostDataset(x=x, max_device_rows=128), device="cpu")


@pytest.mark.parametrize("outofcore", [False, True])
def test_gmm_preempt_resume_exact(outofcore, tmp_path):
    rng = np.random.default_rng(1)
    c = rng.normal(scale=4.0, size=(3, 3))
    x = (c[rng.integers(0, 3, 600)] + rng.normal(scale=0.3, size=(600, 3)) + 20).astype(
        np.float32)
    data = P.HostDataset(x=x, max_device_rows=256) if outofcore else x
    base = dict(k=3, seed=1, max_iter=12, tol=0.0)
    full = P.GaussianMixture(**base).fit(data, device="cpu", on_iteration=lambda *a: None)
    est = P.GaussianMixture(checkpoint_dir=str(tmp_path / "gmm"), checkpoint_every=3, **base)
    with pytest.raises(Preempt):
        est.fit(data, device="cpu", on_iteration=_bomb_at(5))
    # the commit holds unshifted means
    _, arrays, extra = P.FitCheckpointer(est.checkpoint_dir,
                                         _gmm_signature(est, data)).resume()
    assert abs(float(arrays["means"].mean()) - float(x.mean())) < 5 and "prev_ll" in extra
    seen = []
    resumed = est.fit(data, device="cpu", on_iteration=lambda it, ll: seen.append(it))
    assert seen[0] == 4
    for a in ("means", "covariances", "weights"):
        np.testing.assert_array_equal(getattr(resumed, a), getattr(full, a))
    assert resumed.log_likelihood == full.log_likelihood and resumed.n_iter == full.n_iter


def _gmm_signature(est, data):
    """The checkpoint signature the port's GMM writes for ``data``."""
    if isinstance(data, P.HostDataset):
        return {"estimator": "GaussianMixture", "storage": "outofcore", "k": est.k,
                "d": data.n_features, "data": pfc.data_fingerprint(data.x, data.w),
                "n": data.n, "seed": est.seed, "warm": None, "reg_covar": est.reg_covar,
                "tol": est.tol}
    ds = P.device_dataset(data, device="cpu")
    return {"estimator": "GaussianMixture", "k": est.k, "d": data.shape[1],
            "data": pfc.data_fingerprint(ds.x, ds.w), "n_padded": ds.n_padded,
            "seed": est.seed, "warm": None, "reg_covar": est.reg_covar, "tol": est.tol}


@pytest.mark.parametrize("bootstrap", [False, True])
def test_outofcore_forest_preempt_resume_exact(bootstrap, tmp_path):
    x, y = _tree_data()
    hd = P.HostDataset(x=x, y=y, max_device_rows=256)
    kw = dict(task="regression", num_trees=3, max_depth=4, bootstrap=bootstrap,
              subsampling_rate=0.8, seed=0, device="cpu")
    full = peng.grow_forest_outofcore(hd, **kw)
    ck = str(tmp_path / "forest")
    with pytest.raises(Preempt):
        peng.grow_forest_outofcore(hd, checkpoint_dir=ck, on_level=_bomb_at(2), **kw)
    seen = []
    resumed = peng.grow_forest_outofcore(hd, checkpoint_dir=ck, on_level=seen.append, **kw)
    assert seen == [3, 4]
    for a in ("split_feat", "split_bin", "threshold", "value", "importances"):
        np.testing.assert_array_equal(getattr(resumed, a), getattr(full, a))


def test_tree_estimator_checkpoint_roundtrip(tmp_path):
    x, y = _tree_data(n=1500, d=4)
    hd = P.HostDataset(x=x, y=y, max_device_rows=256)
    est = P.DecisionTreeRegressor(max_depth=3, seed=0, checkpoint_dir=str(tmp_path / "dt"),
                                  checkpoint_every=2)
    first = est.fit(hd, device="cpu")
    assert sorted(os.listdir(tmp_path / "dt")) == ["COMMIT", "step-1", "step-3"]
    again = est.fit(hd, device="cpu")          # resumes at the completed state
    np.testing.assert_array_equal(first.split_feat, again.split_feat)
    np.testing.assert_array_equal(first.value, again.value)
    # resident fits ignore checkpoint_dir and grow the same tree
    resident = est.fit((x, y), device="cpu")
    np.testing.assert_array_equal(first.split_feat, resident.split_feat)


# ------------------------------------------------------------- cross-package
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_kmeans_outofcore_checkpoint_resumes_across_packages(writer, tmp_path, mesh8):
    x = _int_blobs()
    ph = P.HostDataset(x=x, max_device_rows=512)
    jh = JHostDataset(x=x, max_device_rows=512)
    base = dict(k=4, seed=0, max_iter=20, tol=0.0)
    full = J.KMeans(**base).fit(jh, mesh=mesh8)
    ck = dict(checkpoint_dir=str(tmp_path / "km"), checkpoint_every=1)
    seen = []
    if writer == "jax":
        with pytest.raises(Preempt):
            J.KMeans(**ck, **base).fit(jh, mesh=mesh8, on_iteration=_bomb_at(2))
        resumed = P.KMeans(**ck, **base).fit(ph, device="cpu",
                                             on_iteration=lambda it, c, m: seen.append(it))
    else:
        with pytest.raises(Preempt):
            P.KMeans(**ck, **base).fit(ph, device="cpu", on_iteration=_bomb_at(2))
        resumed = J.KMeans(**ck, **base).fit(jh, mesh=mesh8,
                                             on_iteration=lambda it, c, m: seen.append(it))
    assert seen[0] == 3
    np.testing.assert_array_equal(np.asarray(resumed.cluster_centers),
                                  np.asarray(full.cluster_centers))
    np.testing.assert_array_equal(np.asarray(resumed.cluster_sizes),
                                  np.asarray(full.cluster_sizes))
    np.testing.assert_allclose(resumed.training_cost, full.training_cost, rtol=1e-5)
    assert full.n_iter <= resumed.n_iter <= full.n_iter + 1


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_forest_outofcore_checkpoint_resumes_across_packages(writer, tmp_path, mesh8):
    x, y = _tree_data()
    ph = P.HostDataset(x=x, y=y, max_device_rows=256)
    jh = JHostDataset(x=x, y=y, max_device_rows=256)
    kw = dict(task="regression", num_trees=3, max_depth=4, bootstrap=True,
              subsampling_rate=0.8, seed=0)
    full = jeng.grow_forest_outofcore(jh, mesh=mesh8, **kw)
    ck = str(tmp_path / "forest")
    seen = []
    if writer == "jax":
        with pytest.raises(Preempt):
            jeng.grow_forest_outofcore(jh, mesh=mesh8, checkpoint_dir=ck,
                                       on_level=_bomb_at(2), **kw)
        resumed = peng.grow_forest_outofcore(ph, device="cpu", checkpoint_dir=ck,
                                             on_level=seen.append, **kw)
    else:
        with pytest.raises(Preempt):
            peng.grow_forest_outofcore(ph, device="cpu", checkpoint_dir=ck,
                                       on_level=_bomb_at(2), **kw)
        resumed = jeng.grow_forest_outofcore(jh, mesh=mesh8, checkpoint_dir=ck,
                                             on_level=seen.append, **kw)
    assert seen == [3, 4]
    for a in ("split_feat", "split_bin", "threshold"):
        np.testing.assert_array_equal(np.asarray(getattr(resumed, a)),
                                      np.asarray(getattr(full, a)))
    np.testing.assert_allclose(np.asarray(resumed.value), np.asarray(full.value), rtol=1e-6)
