"""The port's gradient-boosted trees against the JAX package's, on the CPU.

The same numpy rows (integer-valued features, n a multiple of the JAX
mesh's 8 shards so both packages pad alike) go through the JAX
``GBTRegressor`` / ``GBTClassifier`` on its 8-device CPU mesh and the
port's (``device="cpu"``, K3's plain version).

Tolerances, and why:
- ``split_feat`` and ``threshold`` equal: the thresholds come from the same
  sample and quantiles, and on integer-valued labels the first round's
  histogram sums are exact; later rounds' residuals are float32, summed in
  another order by the two packages, but no split of these data lies
  within that rounding of a tie;
- leaf values within 1e-6, ``init`` within 1e-6 (absolute: the float32
  mean of labels of magnitude 10 can sit near 0): float32 sums in two
  orders;
- predictions within 1e-5 (a sum over rounds of those values);
- the port's own routes (fused, ``fused_rounds=False``, out of core
  against resident without subsampling) give the same trees, values
  within 1e-6 (the out-of-core fit sums block histograms; the resident
  leaf update divides in float32 on the device, the host one in float64).
"""

import numpy as np
import pytest
import torch

import clustermachinelearningforhospitalnetworks_apache_spark_tpu as J
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.parallel.outofcore import (
    HostDataset as JHostDataset,
)
import clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch as P
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.models.tree import (
    engine as peng,
)
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.utils import faults

torch.set_num_threads(1)

BASE = dict(max_iter=5, max_depth=3, seed=0)


def _data(n=2048, d=4, seed=0, integer_labels=True):
    rng = np.random.default_rng(seed)
    x = np.round(rng.normal(size=(n, d)) * 4).astype(np.float32)
    y = x @ rng.normal(size=(d,)) + rng.normal(0, 0.3, size=n)
    y = np.round(y) if integer_labels else y
    return x, y.astype(np.float32)


def _binary(n=2048, d=4, seed=1):
    x, y = _data(n, d, seed)
    return x, (y > np.median(y)).astype(np.float32)


def _same_trees(pm, jm, value_atol=1e-6):
    np.testing.assert_array_equal(pm.split_feat, np.asarray(jm.split_feat))
    np.testing.assert_array_equal(pm.threshold, np.asarray(jm.threshold))
    np.testing.assert_allclose(pm.value, np.asarray(jm.value), atol=value_atol)
    np.testing.assert_allclose(pm.init, jm.init, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(pm.feature_importances, np.asarray(jm.feature_importances),
                               atol=1e-6)
    assert pm.task == jm.task and pm.max_depth == jm.max_depth


def _same_predictions(pm, jm, x):
    np.testing.assert_allclose(pm.predict_numpy(x, device="cpu"),
                               np.asarray(jm.predict_numpy(x)), atol=1e-5)


@pytest.mark.parametrize("integer_labels", [True, False])
@pytest.mark.parametrize("kw", [dict(), dict(step_size=0.3, min_instances_per_node=5),
                                dict(subsampling_rate=0.7)])
def test_regressor_matches_reference(kw, integer_labels):
    x, y = _data(integer_labels=integer_labels)
    jm = J.GBTRegressor(**BASE, **kw).fit((x, y))
    pm = P.GBTRegressor(**BASE, **kw).fit((x, y), device="cpu")
    _same_trees(pm, jm)
    _same_predictions(pm, jm, x)


@pytest.mark.parametrize("weighted", [False, True])
def test_classifier_matches_reference(weighted):
    x, y = _binary()
    if weighted:
        w = np.random.default_rng(2).integers(0, 3, len(y)).astype(np.float32)
        jm = J.GBTClassifier(**BASE).fit((x, y, w))
        pm = P.GBTClassifier(**BASE).fit((x, y, w), device="cpu")
    else:
        jm = J.GBTClassifier(**BASE).fit((x, y))
        pm = P.GBTClassifier(**BASE).fit((x, y), device="cpu")
    _same_trees(pm, jm)
    _same_predictions(pm, jm, x)
    np.testing.assert_allclose(pm.predict_proba(torch.from_numpy(x)).numpy(),
                               np.asarray(jm.predict_proba(x)), atol=1e-6)
    acc_p = float((pm.predict_numpy(x, device="cpu") == y).mean())
    acc_j = float((np.asarray(jm.predict_numpy(x)) == y).mean())
    assert acc_p == acc_j


@pytest.mark.parametrize("task", ["regression", "classification"])
def test_unfused_rounds_give_the_same_trees(task):
    x, y = _data() if task == "regression" else _binary()
    cls = P.GBTRegressor if task == "regression" else P.GBTClassifier
    fused = cls(**BASE).fit((x, y), device="cpu")
    legacy = cls(**BASE, fused_rounds=False, fused_levels=False,
                 use_pallas=True).fit((x, y), device="cpu")
    np.testing.assert_array_equal(fused.split_feat, legacy.split_feat)
    np.testing.assert_array_equal(fused.threshold, legacy.threshold)
    np.testing.assert_array_equal(fused.value, legacy.value)
    assert fused.init == legacy.init


def test_device_tree_arrays_match_the_host_recorder():
    """The device heap arrays that advance the margin are the recorder's
    (values within float32's division rounding)."""
    x, y = _data(n=512)
    ds = P.device_dataset(x, y, device="cpu")
    dfr = peng.grow_forest(ds, task="regression", max_depth=3, defer_fetch=True)
    grown = dfr.fetch()
    is_cat = torch.zeros(4, dtype=torch.bool)
    sf, th, val, cm = peng.device_tree_arrays(
        dfr.level_out, torch.as_tensor(dfr.thr, dtype=torch.float32), is_cat, 32)
    np.testing.assert_array_equal(sf.numpy(), grown.split_feat)
    np.testing.assert_array_equal(th.numpy(), grown.threshold)
    np.testing.assert_allclose(val.numpy(), grown.value, rtol=1e-6)
    assert not cm.any()
    eager = peng.grow_forest(ds, task="regression", max_depth=3)
    np.testing.assert_array_equal(eager.split_feat, grown.split_feat)
    np.testing.assert_array_equal(eager.value, grown.value)


def _table(x, y, is_val):
    cols = {f"f{j}": x[:, j] for j in range(x.shape[1])}
    cols.update(label=y, is_val=is_val)
    return cols


def test_validation_early_stop_matches_reference():
    # integer-valued features and labels, noisy enough to overfit: the
    # held-out loss bottoms out before max_iter
    rng = np.random.default_rng(3)
    n = 800
    x = np.round(rng.uniform(-2, 2, size=(n, 3)) * 4)
    y = np.round(np.sin(x[:, 0] / 2) * 8 + x[:, 1] + 6 * rng.normal(size=n))
    is_val = (np.arange(n) % 10 < 3).astype(np.int64)
    cols = _table(x, y, is_val)
    names = ["f0", "f1", "f2"]
    jt = J.VectorAssembler(names).transform(J.Table.from_dict(cols))
    pt_ = P.VectorAssembler(names).transform(P.Table.from_dict(cols))
    kw = dict(max_iter=40, max_depth=5, step_size=0.5, label_col="label", seed=0,
              validation_indicator_col="is_val", validation_tol=1e-3)
    jm = J.GBTRegressor(**kw).fit(jt)
    pm = P.GBTRegressor(**kw).fit(pt_, device="cpu")
    assert pm.num_trees == jm.num_trees < 40
    _same_trees(pm, jm, value_atol=1e-5)
    # the classifier's LogLoss validation too, at depth 4: at depth 5 a
    # 25-row node can be cut into the same two row sets by two features, an
    # exact tie of gains that the two packages' float32 sums of the
    # two-valued LogLoss residuals break differently (ROADMAP queue 3)
    yb = (y > np.median(y)).astype(np.float64)
    cols = _table(x, yb, is_val)
    jt = J.VectorAssembler(names).transform(J.Table.from_dict(cols))
    pt_ = P.VectorAssembler(names).transform(P.Table.from_dict(cols))
    kw["max_depth"] = 4
    jm = J.GBTClassifier(**kw).fit(jt)
    pm = P.GBTClassifier(**kw).fit(pt_, device="cpu")
    assert pm.num_trees == jm.num_trees
    _same_trees(pm, jm, value_atol=1e-5)


def test_validation_errors():
    x, y = _data(n=64)
    with pytest.raises(ValueError, match="table input"):
        P.GBTRegressor(validation_indicator_col="v").fit((x, y), device="cpu")
    cols = _table(x, y, np.zeros(64, np.int64))
    pt_ = P.VectorAssembler(["f0", "f1"]).transform(P.Table.from_dict(cols))
    with pytest.raises(ValueError, match="no validation rows"):
        P.GBTRegressor(validation_indicator_col="is_val", label_col="label").fit(
            pt_, device="cpu")
    with pytest.raises(ValueError, match="binary"):
        P.GBTClassifier().fit((x, y), device="cpu")
    with pytest.raises(ValueError, match="empty"):
        P.GBTRegressor().fit((x, y, np.zeros(64)), device="cpu")


def _categorical(n=2048, seed=4):
    rng = np.random.default_rng(seed)
    x = np.round(rng.normal(size=(n, 3)) * 3).astype(np.float32)
    cat = rng.integers(0, 5, n)
    x = np.c_[x, cat].astype(np.float32)
    y = np.round(x[:, 0] + np.array([3.0, -2.0, 0.0, 5.0, 1.0])[cat]).astype(np.float32)
    return x, y


@pytest.mark.parametrize("fused_rounds", [True, False])
def test_categorical_matches_reference(fused_rounds):
    x, y = _categorical()
    kw = dict(BASE, categorical_features={3: 5}, fused_rounds=fused_rounds)
    jm = J.GBTRegressor(**kw).fit((x, y))
    pm = P.GBTRegressor(**kw).fit((x, y), device="cpu")
    _same_trees(pm, jm)
    np.testing.assert_array_equal(pm.split_catmask, np.asarray(jm.split_catmask))
    np.testing.assert_array_equal(pm.cat_arities, np.asarray(jm.cat_arities))
    assert (pm.split_catmask != 0).any()
    _same_predictions(pm, jm, x)


@pytest.mark.parametrize("loss", ["squared", "logistic"])
def test_outofcore_matches_resident_and_reference(loss):
    x, y = _data(n=2048) if loss == "squared" else _binary()
    cls_p = P.GBTRegressor if loss == "squared" else P.GBTClassifier
    cls_j = J.GBTRegressor if loss == "squared" else J.GBTClassifier
    kw = dict(max_iter=4, max_depth=2, seed=0)
    ooc = cls_p(**kw).fit(P.HostDataset(x=x, y=y, max_device_rows=512), device="cpu")
    res = cls_p(**kw).fit((x, y), device="cpu")
    _same_trees(ooc, res)
    jooc = cls_j(**kw).fit(JHostDataset(x=x, y=y, max_device_rows=512))
    _same_trees(ooc, jooc)


def test_outofcore_categorical_and_errors():
    x, y = _categorical(n=1024)
    kw = dict(max_iter=3, max_depth=2, seed=0, categorical_features={3: 5})
    ooc = P.GBTRegressor(**kw).fit(P.HostDataset(x=x, y=y, max_device_rows=256), device="cpu")
    jooc = J.GBTRegressor(**kw).fit(JHostDataset(x=x, y=y, max_device_rows=256))
    _same_trees(ooc, jooc)
    np.testing.assert_array_equal(ooc.split_catmask, np.asarray(jooc.split_catmask))
    with pytest.raises(ValueError, match="labels"):
        P.GBTRegressor().fit(P.HostDataset(x=x), device="cpu")
    with pytest.raises(ValueError, match="empty"):
        P.GBTRegressor().fit(P.HostDataset(x=x, y=y, w=np.zeros(len(y))), device="cpu")
    with pytest.raises(ValueError, match="table input"):
        P.GBTRegressor(validation_indicator_col="v").fit(P.HostDataset(x=x, y=y),
                                                         device="cpu")
    with pytest.raises(ValueError, match="binary"):
        P.GBTClassifier().fit(P.HostDataset(x=x, y=y), device="cpu")


@pytest.mark.parametrize("site", ["fit_ckpt.save.arrays", "fit_ckpt.save.commit"])
def test_outofcore_preempt_resumes_to_the_same_trees(tmp_path, site):
    x, y = _data(n=1024)
    hd = P.HostDataset(x=x, y=y, max_device_rows=256)
    kw = dict(max_iter=4, max_depth=2, seed=0)
    uninterrupted = P.GBTRegressor(**kw).fit(hd, device="cpu")
    est = P.GBTRegressor(checkpoint_dir=str(tmp_path / "gbt"), checkpoint_every=1, **kw)
    plan = faults.FaultPlan().crash(site, after=1)    # die on round 1's save
    with faults.active(plan):
        with pytest.raises(faults.InjectedCrash):
            est.fit(hd, device="cpu")
    assert plan.fired(site) == 1
    resumed = est.fit(hd, device="cpu")
    _same_trees(resumed, uninterrupted, value_atol=0.0)


def test_outofcore_checkpoint_resumes_across_packages(tmp_path):
    """The JAX package resumes the port's GBT commit (the signature key for
    key, the arrays by name)."""
    x, y = _data(n=1024)
    kw = dict(max_iter=4, max_depth=2, seed=0)
    ck = str(tmp_path / "gbt")
    est = P.GBTRegressor(checkpoint_dir=ck, checkpoint_every=1, **kw)
    plan = faults.FaultPlan().crash("fit_ckpt.save.arrays", after=2)
    with faults.active(plan):
        with pytest.raises(faults.InjectedCrash):
            est.fit(P.HostDataset(x=x, y=y, max_device_rows=256), device="cpu")
    jm = J.GBTRegressor(checkpoint_dir=ck, checkpoint_every=1, **kw).fit(
        JHostDataset(x=x, y=y, max_device_rows=256))
    pm = P.GBTRegressor(**kw).fit(P.HostDataset(x=x, y=y, max_device_rows=256),
                                  device="cpu")
    _same_trees(pm, jm)


@pytest.mark.parametrize("task", ["regression", "classification"])
def test_artifacts_load_across_packages(tmp_path, task):
    x, y = _data() if task == "regression" else _binary()
    cls_p = P.GBTRegressor if task == "regression" else P.GBTClassifier
    cls_j = J.GBTRegressor if task == "regression" else J.GBTClassifier
    pm = cls_p(**BASE).fit((x, y), device="cpu")
    jm = cls_j(**BASE).fit((x, y))
    pm.save(str(tmp_path / "p"))
    jm.save(str(tmp_path / "j"))
    from_port = J.load_model(str(tmp_path / "p"))
    from_jax = P.load_model(str(tmp_path / "j"))
    assert type(from_jax).__name__ == "GBTModel" and from_jax.task == task
    # one model, two packages: the sum over rounds in two orders
    np.testing.assert_allclose(np.asarray(from_port.predict_numpy(x)),
                               pm.predict_numpy(x, device="cpu"), atol=1e-6)
    np.testing.assert_allclose(from_jax.predict_numpy(x, device="cpu"),
                               np.asarray(jm.predict_numpy(x)), atol=1e-6)
    carried = P.gbt_model_from_jax_arrays(**jm._artifacts()[2], **jm._artifacts()[1])
    np.testing.assert_allclose(carried.predict_numpy(x, device="cpu"),
                               np.asarray(jm.predict_numpy(x)), atol=1e-5)


def test_categorical_artifacts_round_trip(tmp_path):
    x, y = _categorical(n=512)
    pm = P.GBTRegressor(**BASE, categorical_features={3: 5}).fit((x, y), device="cpu")
    pm.save(str(tmp_path / "p"))
    back = J.load_model(str(tmp_path / "p"))
    np.testing.assert_array_equal(np.asarray(back.split_catmask), pm.split_catmask)
    np.testing.assert_allclose(np.asarray(back.predict_numpy(x)),
                               pm.predict_numpy(x, device="cpu"), atol=1e-5)


def test_stage_clock_raises():
    # a stage_clock that is no StageClock raises at the first stage in
    # both packages; out-of-core fits ignore the clock in both
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu.parallel.outofcore import (
        HostDataset as JHostDataset,
    )

    x, y = _data(n=64)
    with pytest.raises(AttributeError, match="stage"):
        J.GBTRegressor(stage_clock=object(), max_iter=1).fit((x, y))
    with pytest.raises(AttributeError, match="stage"):
        P.GBTRegressor(stage_clock=object(), max_iter=1).fit((x, y), device="cpu")
    jm = J.GBTRegressor(stage_clock=object(), **BASE).fit(JHostDataset(x=x, y=y))
    pm = P.GBTRegressor(stage_clock=object(), **BASE).fit(P.HostDataset(x=x, y=y),
                                                          device="cpu")
    assert pm.num_trees == jm.num_trees == BASE["max_iter"]


@pytest.mark.parametrize("route", ["rounds", "validation"])
def test_stage_clock_brackets_the_jax_stages(route):
    """A clocked fit records the JAX fit's stage names, once each, and
    grows the same trees as an unclocked fit (the clock only reads
    time)."""
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu.utils.profiling import (
        StageClock as JClock,
    )
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.utils.profiling import (
        StageClock,
    )

    x, y = _data(n=512)
    if route == "rounds":
        jdata, pdata, kw = (x, y), (x, y), dict(BASE)
    else:
        is_val = (np.arange(len(y)) % 10 < 3).astype(np.int64)
        cols = _table(x, y, is_val)
        names = [f"f{j}" for j in range(x.shape[1])]
        jdata = J.VectorAssembler(names).transform(J.Table.from_dict(cols))
        pdata = P.VectorAssembler(names).transform(P.Table.from_dict(cols))
        kw = dict(BASE, label_col="label", validation_indicator_col="is_val")
    jc, pc = JClock(), StageClock()
    J.GBTRegressor(stage_clock=jc, **kw).fit(jdata)
    clocked = P.GBTRegressor(stage_clock=pc, **kw).fit(pdata, device="cpu")
    assert pc.counts == jc.counts
    assert list(pc.counts) == (["bin", "init", "boost", "fetch_materialize"]
                               if route == "rounds" else ["bin", "init", "boost"])
    assert all(v >= 0.0 for v in pc.seconds.values())
    plain = P.GBTRegressor(**kw).fit(pdata, device="cpu")
    np.testing.assert_array_equal(clocked.split_feat, plain.split_feat)
    np.testing.assert_array_equal(clocked.value, plain.value)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    x, y = _data(n=64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.GBTRegressor(max_iter=1).fit((x, y))
