"""The hospital pipeline's model stage: the port's ``run_model_stage``
against the JAX package's functions called in ``_run``'s order
(``pipeline/hospital_pipeline.py`` §6–§10), on a 2,000-row slice of the
bundled CSV, with 3 trees of depth 3, on the CPU.

Tolerances, and why:
- the CSV table, the seed-42 split indices and the binarized label are
  exactly equal: the same parser, the same threefry permutation;
- LinearRegression: the float32 normal equations of the raw design have
  a condition number near 1.4e7, so two summation orders move the
  smallest coefficient (admission_count, ~1e-3) by ~4e-4 of itself — and
  each side is ~1.5e-3 of itself off the float64 solution.  The
  coefficients and intercept agree within 1e-4 of the largest of them;
- with LOS rounded to integers every histogram sum is exact: the trees
  are equal, and RMSE and accuracy agree at 1e-6 (float32 predictions
  and float32 metric sums in another order);
- on float LOS the gains come from float32 sums in another order, where
  a near tie may flip a split: RMSE at rtol 1e-4, accuracy equal.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import clustermachinelearningforhospitalnetworks_apache_spark_tpu as J
import clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch as P

# the suite runs several worker processes on a few cores: one intra-op
# thread per worker keeps torch from oversubscribing them
torch.set_num_threads(1)

CSV = str(Path(__file__).resolve().parents[1] / "data" / "hospital_patients.csv")
ROWS, DEPTH, TREES = 2000, 3, 3
TREES_NAMES = ("DecisionTreeRegressor", "RandomForestRegressor",
               "DecisionTreeClassifier", "RandomForestClassifier")


def _tables(rounded: bool):
    jt = J.read_csv(CSV, J.hospital_event_schema(), engine="numpy").mask(np.arange(ROWS))
    pt = P.read_csv(CSV, P.hospital_event_schema()).mask(np.arange(ROWS))
    if rounded:
        jt = jt.with_column("length_of_stay", np.round(jt["length_of_stay"]), dtype="float")
        pt = pt.with_column("length_of_stay", np.round(pt["length_of_stay"]), dtype="float")
    return jt.na_drop(), pt.na_drop()


def _jax_stage(table, mesh):
    """§6–§10 of the JAX ``_run``, in its order."""
    assembler = J.VectorAssembler(J.FEATURE_COLS)
    binarizer = J.Binarizer(J.LABEL_COL, "LOS_binary", 5.0)
    train_t, test_t = J.train_test_split(binarizer.transform(table), 0.7, 42)
    train, test = assembler.transform(train_t), assembler.transform(test_t)
    reg_eval = J.RegressionEvaluator("rmse", label_col=J.LABEL_COL)
    models, rmse, acc = {}, {}, {}
    for name, est in {
        "LinearRegression": J.LinearRegression(),
        "DecisionTreeRegressor": J.DecisionTreeRegressor(max_depth=DEPTH),
        "RandomForestRegressor": J.RandomForestRegressor(max_depth=DEPTH, num_trees=TREES),
    }.items():
        models[name] = est.fit(train, label_col=J.LABEL_COL, mesh=mesh)
        rmse[name] = reg_eval.evaluate(
            models[name].transform(test, label_col=J.LABEL_COL, mesh=mesh))
    cls_eval = J.MulticlassClassificationEvaluator("accuracy", label_col="LOS_binary")
    for name, est in {
        "DecisionTreeClassifier": J.DecisionTreeClassifier(max_depth=DEPTH),
        "RandomForestClassifier": J.RandomForestClassifier(max_depth=DEPTH, num_trees=TREES),
    }.items():
        models[name] = est.fit(train, label_col="LOS_binary", mesh=mesh)
        acc[name] = cls_eval.evaluate(
            models[name].transform(test, label_col="LOS_binary", mesh=mesh))
    return models, rmse, acc


@pytest.fixture(scope="module", params=[False, True], ids=["float LOS", "integer LOS"])
def stages(request, mesh1):
    jt, pt = _tables(request.param)
    cfg = P.PipelineConfig(tree_max_depth=DEPTH, rf_num_trees=TREES)
    return request.param, _jax_stage(jt, mesh1), P.run_model_stage(pt, cfg, device="cpu")


def test_read_csv_equals_jax():
    jt = J.read_csv(CSV, J.hospital_event_schema(), engine="numpy")
    pt = P.read_csv(CSV, P.hospital_event_schema())
    assert pt.schema.names == jt.schema.names and pt.num_rows == jt.num_rows == 20_000
    for c in jt.schema.names:
        assert pt[c].dtype == jt[c].dtype, c
        np.testing.assert_array_equal(pt[c], jt[c], err_msg=c)
    # the Arrow engine is ported too (slice 3d): equal to the JAX package's
    ja = J.read_csv(CSV, J.hospital_event_schema(), engine="arrow")
    pa = P.read_csv(CSV, P.hospital_event_schema(), engine="arrow")
    for c in ja.schema.names:
        assert pa[c].dtype == ja[c].dtype, c
        np.testing.assert_array_equal(pa[c], ja[c], err_msg=c)


def test_read_csv_dir_and_window(tmp_path):
    lines = Path(CSV).read_text().splitlines()
    for i, part in enumerate((lines[1:300], lines[300:600])):
        (tmp_path / f"h{i}.csv").write_text("\n".join([lines[0], *part]) + "\n")
    jt = J.read_csv_dir(str(tmp_path), J.hospital_event_schema())
    pt = P.read_csv_dir(str(tmp_path), P.hospital_event_schema())
    win = ("2025-03-31 00:10:00", "2025-03-31 00:20:00")
    jw, pw = jt.between("event_time", *win), pt.between("event_time", *win)
    assert 0 < pw.num_rows == jw.num_rows < pt.num_rows == 599
    for c in jt.schema.names:
        np.testing.assert_array_equal(pw[c], jw[c])
    (tmp_path / "empty").mkdir()
    assert P.read_csv_dir(str(tmp_path / "empty"), P.hospital_event_schema()).num_rows == 0


@pytest.mark.parametrize("n", [0, 1, 10, 2000, 20_000])
def test_split_indices_equal(n):
    for got, ref in zip(P.split_indices(n, [0.7, 0.3], 42), J.core.split.split_indices(n, [0.7, 0.3], 42)):
        np.testing.assert_array_equal(got, ref)


def test_split_and_binarized_labels_equal():
    jt, pt = _tables(False)
    jb = J.Binarizer(J.LABEL_COL, "LOS_binary", 5.0).transform(jt)
    pb = P.Binarizer(P.LABEL_COL, "LOS_binary", 5.0).transform(pt)
    np.testing.assert_array_equal(pb["LOS_binary"], jb["LOS_binary"])
    assert pb.schema.field("LOS_binary").dtype == "int"
    for a, b in zip(P.train_test_split(pb, 0.7, 42), J.train_test_split(jb, 0.7, 42)):
        for c in b.schema.names:
            np.testing.assert_array_equal(a[c], b[c])


def test_linear_regression_coefficients(stages):
    _, (jm, _, _), res = stages
    j, p = jm["LinearRegression"], res.models["LinearRegression"]
    ref = np.r_[np.asarray(j.coefficients), float(j.intercept)]
    got = np.r_[p.coefficients.numpy(), float(p.intercept)]
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()


def test_stage_metrics_and_trees(stages):
    rounded, (jm, rmse, acc), res = stages
    assert res.training_rows == ROWS
    assert set(res.models) == set(jm)
    if rounded:
        for name in TREES_NAMES:
            for k in ("split_feat", "threshold"):
                np.testing.assert_array_equal(getattr(res.models[name], k), getattr(jm[name], k))
            np.testing.assert_allclose(res.models[name].value, jm[name].value, rtol=1e-6)
        for name, v in rmse.items():
            np.testing.assert_allclose(res.regression_rmse[name], v, rtol=1e-6)
        for name, v in acc.items():
            np.testing.assert_allclose(res.classification_accuracy[name], v, rtol=1e-6)
    else:
        for name, v in rmse.items():
            np.testing.assert_allclose(res.regression_rmse[name], v, rtol=1e-4)
        assert res.classification_accuracy == acc
    for name in TREES_NAMES:
        imp = res.feature_importances[name]
        assert list(imp) == list(P.FEATURE_COLS)
        np.testing.assert_allclose(list(imp.values()),
                                   np.round(jm[name].feature_importances, 6), atol=2e-6)


def test_stage_needs_ten_rows():
    _, pt = _tables(False)
    with pytest.raises(ValueError, match="only 9 rows"):
        P.run_model_stage(pt.mask(np.arange(9)), device="cpu")


def test_transform_and_evaluators_on_host_arrays(stages):
    _, (jm, _, _), res = stages
    m = res.models["LinearRegression"]
    x = np.random.default_rng(0).normal(size=(50, 4)).astype(np.float32)
    y = x.sum(1)
    pr = m.transform((x, y), device="cpu")
    pred, lab = pr.to_numpy()
    assert pred.shape == lab.shape == (50,)
    for metric in ("rmse", "mse", "mae", "r2", "var"):
        np.testing.assert_allclose(
            P.RegressionEvaluator(metric).evaluate(pr),
            J.RegressionEvaluator(metric).evaluate(pred, lab), rtol=1e-5)
    cm_p = P.MulticlassClassificationEvaluator()
    cm_j = J.MulticlassClassificationEvaluator()
    yp, yt = (pred > 0).astype(np.float32), (lab > 0).astype(np.float32)
    for metric in ("accuracy", "f1", "weightedPrecision", "weightedRecall"):
        np.testing.assert_allclose(
            P.MulticlassClassificationEvaluator(metric).evaluate(torch.from_numpy(yp), torch.from_numpy(yt)),
            J.MulticlassClassificationEvaluator(metric).evaluate(yp, yt), rtol=1e-6)
    np.testing.assert_array_equal(cm_p.confusion_matrix(yp, yt), cm_j.confusion_matrix(yp, yt))


def test_linear_model_carried_across_predicts_equal(stages):
    _, (jm, _, _), _ = stages
    j = jm["LinearRegression"]
    name, params, arrays = j._artifacts()
    p = P.linear_regression_model_from_jax_arrays(**arrays)
    x = np.random.default_rng(1).normal(size=(64, 4)).astype(np.float32) * 50
    np.testing.assert_allclose(p.predict(torch.from_numpy(x)).numpy(),
                               np.asarray(j.predict(jnp.asarray(x))), rtol=1e-6, atol=1e-5)


def test_num_features_of_linear_and_tree_models(stages):
    """The serve registry sizes its buckets from ``num_features``."""
    _, _, res = stages
    for m in res.models.values():
        assert m.num_features == len(P.FEATURE_COLS)
    srv = P.serve.InferenceServer(device="cpu")
    for name in ("LinearRegression", "RandomForestClassifier"):
        srv.add_model(name, res.models[name], buckets=(1, 4))
        assert srv.registry.get(name).n_features == 4
    x = np.random.default_rng(2).normal(size=(3, 4)).astype(np.float32) * 10
    with srv:
        for name in ("LinearRegression", "RandomForestClassifier"):
            r = srv.predict(name, x)
            assert r.status == "ok"
            # the served batch is padded to the 4-row bucket: a float32
            # product of another shape may round the last bit differently
            np.testing.assert_allclose(
                r.value, res.models[name].predict(torch.from_numpy(x)).numpy(), rtol=1e-6)


def test_later_slices_raise():
    # the elastic net and the training summary came with slice 3e
    # (tests/test_torch_linear_regression.py holds them to the reference);
    # what still raises is the summary of a model without one
    x = np.random.default_rng(3).normal(size=(20, 2)).astype(np.float32)
    m = P.LinearRegression(reg_param=0.1, elastic_net_param=0.5).fit((x, x[:, 0]),
                                                                     device="cpu")
    assert m.fit_info["n_iter"] > 0 and np.isfinite(m.summary.r2)
    m = P.LinearRegression().fit((x, x[:, 0]), device="cpu")
    assert np.isfinite(m.summary.t_values).all()
    m.release_summary()
    with pytest.raises(RuntimeError, match="summary"):
        m.summary
