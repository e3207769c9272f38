"""Model artifacts shared by the two packages, on the CPU.

A model fitted and saved by the JAX package loads in the port and the
other way round; a re-save by the other package writes the same bytes.
The durability contract (staged save, two-rename swap, repair on load,
CRC32C manifest) is the JAX package's, mirrored from
``tests/test_chaos.py`` with the port's ``FaultPlan`` at the same sites.

Tolerances, and why:
- KMeans assignments and every tree's output are equal: the same float32
  centers and heap arrays, compared and traversed the same way;
- a random forest regressor's mean over trees is summed in another order:
  rtol 1e-6 (as ``tests/test_torch_trees.py``);
- LinearRegression predictions at rtol 1e-6, atol 1e-5 (as
  ``tests/test_torch_hospital_stage.py``): a float32 dot product summed in
  another order;
- the scaler on a host matrix is equal (the same numpy arithmetic), and
  on a tensor within the LinearRegression tolerance: float32 arithmetic
  on another backend;
- ``arrays.npz`` byte-identical and ``metadata.json`` equal, CRC32C
  included: the same keys, dtypes, shapes and parameter types.
"""

import json
import os
import sys
import threading
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import clustermachinelearningforhospitalnetworks_apache_spark_tpu as J
import clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch as P
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.io import integrity as j_integrity
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.io import model_io as j_io
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.utils import faults as j_faults
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.io import integrity as p_integrity
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.io import model_io as p_io
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.utils import faults as p_faults

# the suite runs several worker processes on a few cores: one intra-op
# thread per worker keeps torch from oversubscribing them
torch.set_num_threads(1)

CSV = str(Path(__file__).resolve().parents[1] / "data" / "hospital_patients.csv")
SAVE_SITES = ["model_io.save.arrays", "model_io.save.meta", "model_io.save.swap"]
KINDS = ["KMeansModel", "StandardScalerModel", "LinearRegressionModel",
         "DecisionTreeModel", "RandomForestModel:classifier", "RandomForestModel:categorical"]
LR_TOL = dict(rtol=1e-6, atol=1e-5)


def _data(kind: str, seed: int = 0):
    """Seed-made rows for ``kind``: blobs for KMeans, a noisy linear label
    otherwise, a 5-valued categorical column for the categorical forest."""
    rng = np.random.default_rng(seed)
    if kind == "KMeansModel":
        centers = rng.normal(0, 3, size=(6, 5))
        x = centers[rng.integers(0, 6, 400)] + rng.normal(scale=0.3, size=(400, 5))
        return x.astype(np.float32), None
    x = rng.normal(size=(400, 5)).astype(np.float32)
    if kind.endswith("categorical"):
        x[:, 4] = rng.integers(0, 5, 400)
    y = (x @ np.array([1.0, -2.0, 0.5, 0.0, 3.0]) + rng.normal(0, 0.3, 400)).astype(np.float32)
    if kind.endswith("classifier"):
        y = (y > 0).astype(np.float32)
    return x, y


def _fit(pkg, kind: str, mesh1):
    """A small model of ``kind`` fitted by ``pkg`` (J on a one-device mesh,
    P on the CPU)."""
    x, y = _data(kind)
    on = {"mesh": mesh1} if pkg is J else {"device": "cpu"}
    if kind == "KMeansModel":
        return pkg.KMeans(k=6, seed=0).fit(x, **on)
    if kind == "StandardScalerModel":
        return J.StandardScaler().fit(x) if pkg is J else P.StandardScaler().fit(x, device="cpu")
    if kind == "LinearRegressionModel":
        return pkg.LinearRegression().fit((x, y), **on)
    if kind == "DecisionTreeModel":
        return pkg.DecisionTreeRegressor(max_depth=4).fit((x, y), **on)
    if kind == "RandomForestModel:classifier":
        return pkg.RandomForestClassifier(num_trees=3, max_depth=4, seed=1).fit((x, y), **on)
    return pkg.RandomForestRegressor(num_trees=3, max_depth=4, seed=1,
                                     categorical_features={4: 5}).fit((x, y), **on)


def _save(io_mod, model, path: str) -> None:
    """``model.write().overwrite().save`` where the model has it; the
    scaler through ``save_model(path, *scaler._artifacts())``."""
    if hasattr(model, "write"):
        model.write().overwrite().save(path)
    else:
        io_mod.save_model(path, *model._artifacts())


def _assert_same_predictions(kind: str, pm, jm, seed: int = 1):
    """The port model ``pm`` and the JAX model ``jm`` on the same rows."""
    x, _ = _data(kind, seed)
    if kind == "StandardScalerModel":
        np.testing.assert_array_equal(pm.transform(x), jm.transform(x))
        np.testing.assert_allclose(pm.transform(torch.from_numpy(x)).numpy(),
                                   np.asarray(jm.transform(jnp.asarray(x))), **LR_TOL)
        return
    got = pm.predict(torch.from_numpy(x)).numpy()
    ref = np.asarray(jm.predict(jnp.asarray(x)))
    if kind == "LinearRegressionModel":
        np.testing.assert_allclose(got, ref, **LR_TOL)
        return
    if kind.startswith(("DecisionTree", "RandomForest")):
        np.testing.assert_array_equal(pm._tree_outputs(torch.from_numpy(x)).numpy(),
                                      np.asarray(jm._tree_outputs(jnp.asarray(x))))
    if kind == "RandomForestModel:categorical":
        np.testing.assert_allclose(got, ref, rtol=1e-6)
    else:
        np.testing.assert_array_equal(got, ref)


def _assert_same_files(a: str, b: str) -> None:
    """Byte-identical ``arrays.npz``; equal parsed ``metadata.json``."""
    assert Path(a, "arrays.npz").read_bytes() == Path(b, "arrays.npz").read_bytes()
    ma = json.loads(Path(a, "metadata.json").read_text())
    mb = json.loads(Path(b, "metadata.json").read_text())
    assert ma == mb
    assert ma["integrity"]["arrays.npz"]["crc32c"]  # the manifest is there


@pytest.fixture(scope="module")
def jax_models(mesh1):
    return {kind: _fit(J, kind, mesh1) for kind in KINDS}


@pytest.fixture(scope="module")
def port_models(mesh1):
    return {kind: _fit(P, kind, mesh1) for kind in KINDS}


# ---------------------------------------------------------- JAX → port
@pytest.mark.parametrize("kind", KINDS)
def test_jax_artifact_loads_in_port_and_predicts_the_same(kind, jax_models, tmp_path):
    jm = jax_models[kind]
    _save(j_io, jm, str(tmp_path / "jax"))
    pm = P.load_model(str(tmp_path / "jax"))
    assert type(pm).__module__.startswith(P.__name__)
    assert type(pm).__name__ == kind.split(":")[0]
    _assert_same_predictions(kind, pm, jm)


@pytest.mark.parametrize("kind", KINDS)
def test_port_resave_of_jax_artifact_is_byte_identical(kind, jax_models, tmp_path):
    _save(j_io, jax_models[kind], str(tmp_path / "jax"))
    _save(p_io, P.load_model(str(tmp_path / "jax")), str(tmp_path / "port"))
    _assert_same_files(str(tmp_path / "jax"), str(tmp_path / "port"))


# ---------------------------------------------------------- one constructor
@pytest.mark.parametrize("kind", KINDS)
def test_in_memory_bridge_builds_what_load_model_builds(kind, jax_models, tmp_path):
    """``convert``'s functions and ``load_model`` run the same
    ``from_artifacts``: the model carried across in memory predicts as the
    JAX model and saves the bytes the JAX package saved."""
    jm = jax_models[kind]
    name, params, arrays = jm._artifacts()
    if name == "KMeansModel":
        carried = P.kmeans_model_from_jax_arrays(**arrays, **params)
    elif name == "StandardScalerModel":
        carried = P.scaler_model_from_jax_arrays(**arrays, **params)
    elif name == "LinearRegressionModel":
        carried = P.linear_regression_model_from_jax_arrays(**arrays, **params)
    else:
        carried = P.tree_model_from_jax_arrays(**arrays, **params, name=name)
    assert type(carried).__name__ == name
    _assert_same_predictions(kind, carried, jm)
    _save(j_io, jm, str(tmp_path / "jax"))
    _save(p_io, carried, str(tmp_path / "carried"))
    _assert_same_files(str(tmp_path / "jax"), str(tmp_path / "carried"))


def test_float64_payloads_build_the_float32_models_predict_needs():
    lr = P.LinearRegressionModel.from_artifacts(
        {}, {"coefficients": np.array([1.0, -2.0, 0.5]), "intercept": np.float64(0.25)})
    assert lr.coefficients.dtype == torch.float32 and lr.intercept.dtype == torch.float32
    np.testing.assert_array_equal(lr.predict(torch.ones(2, 3)).numpy(), [-0.25, -0.25])
    km = P.KMeansModel.from_artifacts({}, {"cluster_centers": np.eye(3)})
    assert km.cluster_centers.dtype == np.float32 and km.cluster_sizes is None
    np.testing.assert_array_equal(km.predict(torch.eye(3)).numpy(), [0, 1, 2])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cosine_kmeans_artifact_loads_across_packages_and_predicts_the_same(
        writer, mesh1, tmp_path):
    """A cosine KMeans saved by either package loads in the other, which
    predicts on unit rows (K2's plain version here) as the writer does;
    the cost at rtol 1e-5 (float32 sums in another order)."""
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(600, 4)) + rng.integers(-3, 4, size=(600, 1))).astype(np.float32)
    est = dict(k=4, seed=0, max_iter=5, distance_measure="cosine")
    if writer == "jax":
        fitted = J.KMeans(**est).fit(x, mesh=mesh1)
        _save(j_io, fitted, str(tmp_path / "m"))
        jm, pm = fitted, P.load_model(str(tmp_path / "m"))
    else:
        fitted = P.KMeans(**est).fit(x, device="cpu")
        _save(p_io, fitted, str(tmp_path / "m"))
        jm, pm = J.load_model(str(tmp_path / "m")), fitted
    assert pm.distance_measure == jm.distance_measure == "cosine"
    np.testing.assert_array_equal(pm.predict_numpy(x, device="cpu"),
                                  np.asarray(jm.predict(jnp.asarray(x))))
    np.testing.assert_allclose(pm.compute_cost(x, device="cpu"), jm.compute_cost(x),
                               rtol=1e-5)


# ---------------------------------------------------------- port → JAX
@pytest.mark.parametrize("kind", KINDS)
def test_port_artifact_loads_in_jax_and_predicts_the_same(kind, port_models, tmp_path):
    pm = port_models[kind]
    _save(p_io, pm, str(tmp_path / "port"))
    jm = J.load_model(str(tmp_path / "port"))
    assert type(jm).__module__.startswith(J.__name__ + ".")
    assert type(jm).__name__ == kind.split(":")[0]
    _assert_same_predictions(kind, pm, jm)
    # and the JAX package's re-save writes the same bytes
    _save(j_io, jm, str(tmp_path / "jax"))
    _assert_same_files(str(tmp_path / "port"), str(tmp_path / "jax"))


def test_port_artifacts_have_the_reference_keys_dtypes_and_types(port_models, tmp_path):
    want = {
        "KMeansModel": ({"distance_measure": str, "training_cost": float, "n_iter": int},
                        {"cluster_centers": (np.float32, 2), "cluster_sizes": (np.float32, 1)}),
        "StandardScalerModel": ({"with_mean": bool, "with_std": bool},
                                {"mean": (np.float64, 1), "std": (np.float64, 1)}),
        "LinearRegressionModel": ({}, {"coefficients": (np.float32, 1),
                                       "intercept": (np.float32, 0)}),
        "DecisionTreeModel": ({"task": str, "num_classes": int, "max_depth": int},
                              {"split_feat": (np.int32, 2), "threshold": (np.float32, 2),
                               "value": (np.float32, 3),
                               "feature_importances": (np.float64, 1)}),
    }
    for kind, (params, arrays) in want.items():
        name, got_params, got_arrays = port_models[kind]._artifacts()
        assert name == kind
        assert {k: type(v) for k, v in got_params.items()} == params
        assert {k: (v.dtype.type, v.ndim) for k, v in got_arrays.items()} == arrays
    # the categorical forest adds the category masks, and only it
    _, _, cat = port_models["RandomForestModel:categorical"]._artifacts()
    assert (cat["split_catmask"].dtype, cat["cat_arities"].dtype) == (np.uint32, np.int32)
    assert "split_catmask" not in port_models["RandomForestModel:classifier"]._artifacts()[2]
    # a model without sizes writes float64 zeros, as the reference does
    _, _, km = P.KMeansModel(np.ones((3, 2), np.float32))._artifacts()
    assert km["cluster_sizes"].dtype == np.float64 and not km["cluster_sizes"].any()


# ---------------------------------------------------------- save kills
def _toy(scale: float) -> "P.KMeansModel":
    return P.KMeansModel(
        cluster_centers=np.full((2, 3), scale, np.float32),
        distance_measure="euclidean",
        training_cost=1.0,
        n_iter=1,
        cluster_sizes=np.array([1.0, 1.0], np.float32),
    )


def _jax_toy(scale: float):
    return J.KMeansModel(
        cluster_centers=np.full((2, 3), scale, np.float32),
        distance_measure="euclidean",
        training_cost=1.0,
        n_iter=1,
        cluster_sizes=np.array([1.0, 1.0], np.float32),
    )


@pytest.mark.parametrize("site", SAVE_SITES)
def test_port_save_killed_preserves_previous_artifact(tmp_path, site):
    path = str(tmp_path / "model")
    _toy(1.0).save(path)
    rows = np.full((4, 3), 1.0, np.float32)
    plan = p_faults.FaultPlan().crash(site)
    with p_faults.active(plan):
        with pytest.raises(p_faults.InjectedCrash) as err:
            _toy(2.0).save(path, overwrite=True)
    assert plan.fired(site) == 1 and err.value.site == site
    m = P.load_model(path)  # repairs a displaced artifact if needed
    np.testing.assert_array_equal(m.cluster_centers, np.full((2, 3), 1.0, np.float32))
    np.testing.assert_array_equal(m.predict_numpy(rows, device="cpu"), [0, 0, 0, 0])
    # and the NEXT save over the crash debris works
    _toy(3.0).write().overwrite().save(path)
    np.testing.assert_array_equal(P.load_model(path).cluster_centers,
                                  np.full((2, 3), 3.0, np.float32))


@pytest.mark.parametrize("site", SAVE_SITES)
@pytest.mark.parametrize("killed", ["jax", "port"])
def test_save_killed_in_one_package_repairs_in_the_other(tmp_path, site, killed):
    """One package's save dies at ``site``; the other package loads the
    previous artifact and saves over the debris."""
    path = str(tmp_path / "model")
    if killed == "jax":
        _jax_toy(1.0).save(path)
        plan = j_faults.FaultPlan().crash(site)
        with j_faults.active(plan), pytest.raises(j_faults.InjectedCrash):
            _jax_toy(2.0).save(path, overwrite=True)
        loader, saver = P.load_model, _toy
    else:
        _toy(1.0).save(path)
        plan = p_faults.FaultPlan().crash(site)
        with p_faults.active(plan), pytest.raises(p_faults.InjectedCrash):
            _toy(2.0).save(path, overwrite=True)
        loader, saver = J.load_model, _jax_toy
    assert plan.fired(site) == 1
    np.testing.assert_array_equal(loader(path).cluster_centers, np.full((2, 3), 1.0, np.float32))
    saver(3.0).save(path, overwrite=True)
    np.testing.assert_array_equal(loader(path).cluster_centers, np.full((2, 3), 3.0, np.float32))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_displaced_artifact_is_restored_by_the_other_package(tmp_path, writer):
    """A crash between the swap's two renames leaves the committed
    artifact at ``<path>.old`` and nothing at ``<path>``: either package's
    load puts it back."""
    path = str(tmp_path / "model")
    (_jax_toy if writer == "jax" else _toy)(1.0).save(path)
    os.replace(path, path + ".old")
    loader = P.load_model if writer == "jax" else J.load_model
    np.testing.assert_array_equal(loader(path).cluster_centers, np.full((2, 3), 1.0, np.float32))
    assert os.path.isdir(path) and not os.path.exists(path + ".old")


def test_overwrite_false_refuses_an_existing_artifact(tmp_path):
    path = str(tmp_path / "model")
    _toy(1.0).save(path)
    with pytest.raises(FileExistsError):
        _toy(2.0).save(path, overwrite=False)
    with pytest.raises(FileExistsError):
        _toy(2.0).write().save(path)
    np.testing.assert_array_equal(P.load_model(path).cluster_centers, np.full((2, 3), 1.0, np.float32))


def test_composite_prepare_finalize_protocol_survives_crash(tmp_path):
    """Composite savers write in place between prepare_artifact_dir and
    finalize_artifact_dir; a crash in between must leave the PREVIOUS
    committed artifact recoverable."""
    path = str(tmp_path / "composite")
    p_io.prepare_artifact_dir(path, overwrite=True)
    Path(path, "payload").write_text("v1")
    p_io.finalize_artifact_dir(path)
    assert not os.path.exists(os.path.join(path, p_io.INCOMPLETE_SENTINEL))

    # v2 save crashes mid-write: sentinel still present, v1 displaced
    p_io.prepare_artifact_dir(path, overwrite=True)
    Path(path, "payload").write_text("v2-torn")
    # "restart": repair discards the torn save and restores v1
    p_io.repair_artifact_dir(path)
    assert Path(path, "payload").read_text() == "v1"
    with pytest.raises(FileExistsError):
        p_io.prepare_artifact_dir(path, overwrite=False)


# ---------------------------------------------------------- corruption
def test_model_load_detects_bitflip(tmp_path):
    path = str(tmp_path / "model")
    _toy(1.0).save(path)
    f = os.path.join(path, "arrays.npz")
    data = bytearray(open(f, "rb").read())
    data[len(data) // 2] ^= 0xFF
    open(f, "wb").write(bytes(data))
    with pytest.raises(P.CorruptArtifactError, match="crc32c mismatch"):
        P.load_model(path)


def test_model_load_detects_truncation(tmp_path):
    path = str(tmp_path / "model")
    _toy(1.0).save(path)
    f = os.path.join(path, "arrays.npz")
    data = open(f, "rb").read()
    open(f, "wb").write(data[: len(data) // 2])
    with pytest.raises(P.CorruptArtifactError, match="size mismatch"):
        P.load_model(path)


def test_model_save_corrupted_in_flight_detected(tmp_path):
    """Bytes corrupted between checksum and platter: the manifest carries
    the intended CRC, so load catches it."""
    path = str(tmp_path / "model")
    plan = p_faults.FaultPlan().corrupt("model_io.save.arrays", at_byte=64)
    with p_faults.active(plan):
        _toy(1.0).save(path)
    assert plan.fired("model_io.save.arrays") == 1
    with pytest.raises(P.CorruptArtifactError):
        P.load_model(path)


def test_torn_metadata_and_undecodable_payload_are_corrupt(tmp_path):
    path = str(tmp_path / "model")
    _toy(1.0).save(path)
    meta = Path(path, "metadata.json")
    meta.write_text(meta.read_text()[:20])
    with pytest.raises(P.CorruptArtifactError, match="unreadable"):
        P.load_model(path)
    # a payload without a manifest entry is decoded unchecked: garbage is
    # still a typed error
    p_io.save_model(path, "KMeansModel", {}, {"cluster_centers": np.ones((2, 3), np.float32)})
    m = json.loads(meta.read_text())
    del m["integrity"]
    meta.write_text(json.dumps(m))
    Path(path, "arrays.npz").write_bytes(b"not a zip")
    with pytest.raises(P.CorruptArtifactError, match="undecodable"):
        P.load_model(path)


# ---------------------------------------------------------- the registry of classes
def test_pipeline_model_tag_names_the_missing_port_module(tmp_path):
    """The PipelineModel tag resolves to the port's own
    ``pipeline/ml_pipeline.py`` (it raised ModuleNotFoundError until the
    port had that module)."""
    path = str(tmp_path / "pipe")
    p_io.prepare_artifact_dir(path, overwrite=True)
    p_io.write_metadata(path, {"model_class": "PipelineModel", "stage_dirs": []})
    p_io.finalize_artifact_dir(path)
    loaded = P.load_model(path)
    assert type(loaded) is P.PipelineModel and loaded.stages == ()
    assert type(loaded).__module__ == f"{P.__name__}.pipeline.ml_pipeline"
    assert p_io.is_composite(object()) is False


def test_unknown_class_and_unpersistable_objects(tmp_path):
    path = str(tmp_path / "odd")
    p_io.save_model(path, "NoSuchModel", {}, {})
    with pytest.raises(KeyError, match="NoSuchModel"):
        P.load_model(path)
    with pytest.raises(TypeError, match="not persistable"):
        p_io.validate_persistable(object(), "stage 0")
    p_io.validate_persistable(_toy(1.0))
    p_io.validate_persistable(P.StandardScalerModel(np.zeros(2), np.ones(2)))


def test_register_composite_dispatches_load(tmp_path, monkeypatch):
    class Composite:
        @classmethod
        def load(cls, path, _meta=None):
            return ("loaded", path, _meta["model_class"])

    mod = types.ModuleType("composite_for_test")
    mod.Composite = Composite
    monkeypatch.setitem(sys.modules, "composite_for_test", mod)
    monkeypatch.setitem(p_io._COMPOSITE_LOADERS, "Composite", "composite_for_test:Composite")
    path = str(tmp_path / "c")
    p_io.prepare_artifact_dir(path, overwrite=True)
    p_io.write_metadata(path, {"model_class": "Composite"})
    p_io.finalize_artifact_dir(path)
    assert P.load_model(path) == ("loaded", path, "Composite")


def test_data_profile_and_fingerprint(tmp_path):
    path = str(tmp_path / "model")
    _toy(1.0).save(path)
    crc = json.loads(Path(path, "metadata.json").read_text())["integrity"]["arrays.npz"]["crc32c"]
    assert p_io.artifact_fingerprint(path) == crc
    assert p_io.load_data_profile(path) is None
    p_io.attach_data_profile(path, {"features": ["a"], "mean": [1.5]})
    assert p_io.load_data_profile(path) == {"features": ["a"], "mean": [1.5]}
    # the JAX package reads the profile the port attached, and vice versa
    assert j_io.load_data_profile(path) == {"features": ["a"], "mean": [1.5]}
    j_io.attach_data_profile(path, {"n": 3})
    assert p_io.load_data_profile(path) == {"n": 3}
    assert p_io.artifact_fingerprint(path) == crc  # payload untouched
    assert p_io.artifact_fingerprint(str(tmp_path / "missing")) is None
    assert p_io.load_data_profile(str(tmp_path / "missing")) is None


# ---------------------------------------------------------- CRC32C
def test_crc32c_known_vectors_on_both_paths():
    for fn in (p_integrity.crc32c, p_integrity.crc32c_pure):
        assert fn(b"123456789") == 0xE3069283
        assert fn(b"\x00" * 32) == 0x8A9136AA
        assert fn(b"") == 0
    assert p_integrity.crc32c_hex(b"123456789") == "e3069283"


@pytest.mark.parametrize("size", [1, 7, 64, 4097])
def test_crc32c_agrees_with_jax_on_random_bytes(size):
    data = np.random.default_rng(size).integers(0, 256, size, dtype=np.uint8).tobytes()
    want = j_integrity.crc32c(data)
    assert p_integrity.crc32c_pure(data) == want
    assert p_integrity.crc32c(data) == want
    # chained partial computations give the one-shot digest
    cut = size // 3
    assert p_integrity.crc32c_pure(data[cut:], p_integrity.crc32c_pure(data[:cut])) == want
    assert p_integrity.checksum_record(data) == j_integrity.checksum_record(data)


def test_verify_bytes_reports_size_then_crc():
    rec = p_integrity.checksum_record(b"abcdef")
    assert p_integrity.verify_bytes(b"abcdef", rec) is None
    assert "size mismatch" in p_integrity.verify_bytes(b"abcde", rec)
    assert "crc32c mismatch" in p_integrity.verify_bytes(b"abcdeg", rec)


# ---------------------------------------------------------- FaultPlan parity
_CSV_TEXT = "a,b,c\n" + "".join(f"{i},{i * 0.5},{i % 3}\n" for i in range(40))


@pytest.mark.parametrize("rule", ["mangle_fields", "shuffle_columns", "unit_scale", "nan_burst"])
def test_fault_plan_data_rules_rewrite_like_jax(rule):
    """The same seeded data rule rewrites the same CSV text the same way."""
    args = {"mangle_fields": dict(rate=0.2), "shuffle_columns": {},
            "unit_scale": dict(column="b", factor=60.0),
            "nan_burst": dict(column="c", length=5)}[rule]
    out = []
    for mod in (j_faults, p_faults):
        plan = getattr(mod.FaultPlan(seed=3), rule)("ingest.*", **args)
        with mod.active(plan):
            assert mod.data_rules_active("ingest.csv_text")
            out.append(mod.corrupt_data("ingest.csv_text", _CSV_TEXT, path="f.csv"))
        assert plan.fired("ingest.csv_text") == 1
    assert out[0] == out[1] != _CSV_TEXT


def test_fault_plan_byte_rules_match_jax():
    """tear, disk_full, corrupt, fail and delay: the same answers, counts
    and error types at the same calls."""
    seen = []
    for mod in (j_faults, p_faults):
        plan = (mod.FaultPlan().tear("wal.append", at_byte=-1, after=1)
                .disk_full("wal.*", after_bytes=10)
                .corrupt("ckpt.write", at_byte=2, flip_mask=0x0F)
                .fail("io.read", times=2)
                .delay("io.slow", 0.0))
        got = []
        with mod.active(plan):
            got.append([mod.torn_point("wal.append", 8) for _ in range(3)])
            got.append([mod.enospc_point("wal.write", 6) for _ in range(3)])
            got.append(mod.mangle_bytes("ckpt.write", b"abcdef"))
            for _ in range(3):
                try:
                    mod.fault_point("io.read")
                    got.append("ok")
                except OSError as e:
                    got.append(type(e).__name__)
            mod.fault_point("io.slow")
            try:
                mod.fault_point("wal.fsync")
                got.append("ok")
            except OSError as e:
                got.append(e.errno)
        assert mod.torn_point("wal.append", 8) is None  # no plan installed
        seen.append((got, plan.calls, plan.log))
    assert seen[0] == seen[1]
    assert seen[1][0][0] == [None, 7, None] and seen[1][0][1] == [None, 4, None]


# ---------------------------------------------------------- transform on tables
def test_clustering_transform_on_a_table_matches_jax(mesh1, tmp_path):
    jt = J.read_csv(CSV, J.hospital_event_schema(), engine="numpy").mask(np.arange(2000)).na_drop()
    pt = P.read_csv(CSV, P.hospital_event_schema()).mask(np.arange(2000)).na_drop()
    ja = J.VectorAssembler(J.FEATURE_COLS).transform(jt)
    pa = P.VectorAssembler(P.FEATURE_COLS).transform(pt)
    jm = J.KMeans(k=5, seed=0).fit(ja, mesh=mesh1)
    jm.save(str(tmp_path / "km"))
    pm = P.load_model(str(tmp_path / "km"))        # the centers carried across
    want = jm.transform(ja)
    got = pm.transform(pa, device="cpu")
    assert isinstance(got, P.Table)
    assert got.schema.names == [*pt.schema.names, "prediction"] == want.schema.names
    assert got.schema.field("prediction").dtype == "int"
    np.testing.assert_array_equal(got["prediction"], want["prediction"])
    np.testing.assert_array_equal(got["prediction"], pm.predict_numpy(pa.features, device="cpu"))
    for c in pt.schema.names:
        np.testing.assert_array_equal(got[c], pt[c])
    # other inputs keep the base behavior
    res = pm.transform(pa.features, device="cpu")
    assert isinstance(res, P.PredictionResult)
    np.testing.assert_array_equal(res.to_numpy()[0], got["prediction"])


# ---------------------------------------------------------- serving
def test_registry_loads_serves_and_installs(port_models, tmp_path):
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.serve import (
        InferenceServer, ModelRegistry, ServingModel,
    )

    km = port_models["KMeansModel"]
    lr = port_models["LinearRegressionModel"]
    km.save(str(tmp_path / "km"))
    x, _ = _data("KMeansModel", seed=2)
    reg = ModelRegistry()
    sm = reg.load("m", str(tmp_path / "km"), buckets=(1, 8, 64), warmup=True, device="cpu")
    assert reg.names() == ["m"] and reg.get("m") is sm
    assert reg.metrics.snapshot()["warmup_compiles"] == 3
    np.testing.assert_array_equal(sm.predict(x), km.predict_numpy(x, device="cpu"))
    assert reg.metrics.snapshot()["recompiles"] == 0

    # install swaps the model under the same name in one step
    new = ServingModel(lr, buckets=(1, 8, 64), device="cpu").warmup()
    assert reg.install("m", new) is new and reg.get("m") is new
    np.testing.assert_allclose(reg.get("m").predict(x), lr.predict_numpy(x, device="cpu"), **LR_TOL)

    # the server takes a saved-artifact path where it takes a model
    with InferenceServer(device="cpu") as srv:
        srv.add_model("km", str(tmp_path / "km"), buckets=(1, 8, 64))
        answers = [srv.predict("km", x[i : i + 5]) for i in range(0, 40, 5)]
    for i, r in zip(range(0, 40, 5), answers):
        assert r.status == "ok"
        np.testing.assert_array_equal(r.value, km.predict_numpy(x[i : i + 5], device="cpu"))


def test_server_hot_adds_a_saved_model_warmed_before_it_serves(port_models, tmp_path):
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.serve import (
        InferenceServer,
    )

    km = port_models["KMeansModel"]
    km.save(str(tmp_path / "km"))
    x, _ = _data("KMeansModel", seed=3)
    with InferenceServer(device="cpu") as srv:
        before = srv.metrics.snapshot()["warmup_compiles"]
        srv.add_model("km", str(tmp_path / "km"), buckets=(1, 8, 64))
        assert srv.metrics.snapshot()["warmup_compiles"] == before + 3
        r = srv.predict("km", x[:5])
    assert r.status == "ok"
    np.testing.assert_array_equal(r.value, km.predict_numpy(x[:5], device="cpu"))
    assert srv.metrics.snapshot()["recompiles"] == 0


def test_registry_install_is_atomic_under_concurrent_reads(port_models):
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.serve import (
        ModelRegistry, ServingModel,
    )

    reg = ModelRegistry()
    a = reg.register("m", port_models["KMeansModel"], buckets=(8,), device="cpu")
    b = ServingModel(port_models["KMeansModel"], buckets=(8,), device="cpu")
    seen, stop = set(), threading.Event()

    def reader():
        while not stop.is_set():
            seen.add(id(reg.get("m")))

    t = threading.Thread(target=reader)
    t.start()
    for _ in range(50):
        reg.install("m", b)
        reg.install("m", a)
    stop.set()
    t.join(10)
    assert seen <= {id(a), id(b)} and reg.get("m") is a


# ---------------------------------------------------------- the stage's §11
def test_stage_saves_models_that_the_jax_package_loads(tmp_path):
    table = P.read_csv(CSV, P.hospital_event_schema()).mask(np.arange(2000)).na_drop()
    cfg = P.PipelineConfig(tree_max_depth=3, rf_num_trees=3,
                           model_save_path=str(tmp_path / "hospital"))
    res = P.run_model_stage(table, cfg, device="cpu", save_models=True)
    short = {"LinearRegression": "lr", "DecisionTreeRegressor": "dt",
             "RandomForestRegressor": "rf", "DecisionTreeClassifier": "dt_class",
             "RandomForestClassifier": "rf_class"}
    assert res.model_paths == {k: str(tmp_path / "hospital" / v) for k, v in short.items()}
    assert sorted(os.listdir(tmp_path / "hospital")) == sorted(short.values())
    assert all(f"save:{name}" in res.seconds for name in short)
    x = P.VectorAssembler(P.FEATURE_COLS).transform(table).features.astype(np.float32)
    for name, path in res.model_paths.items():
        pm = res.models[name]
        jm = J.load_model(path)
        assert type(jm).__name__ == type(pm).__name__
        got = pm.predict(torch.from_numpy(x)).numpy()
        ref = np.asarray(jm.predict(jnp.asarray(x)))
        if name == "LinearRegression":
            np.testing.assert_allclose(got, ref, **LR_TOL)
        elif name == "RandomForestRegressor":
            np.testing.assert_allclose(got, ref, rtol=1e-6)
        else:
            np.testing.assert_array_equal(got, ref)
        # and the port's own load predicts exactly what the fitted model does
        np.testing.assert_array_equal(P.load_model(path).predict(torch.from_numpy(x)).numpy(), got)


def test_stage_does_not_save_by_default(tmp_path):
    table = P.read_csv(CSV, P.hospital_event_schema()).mask(np.arange(300)).na_drop()
    cfg = P.PipelineConfig(tree_max_depth=2, rf_num_trees=2,
                           model_save_path=str(tmp_path / "hospital"))
    res = P.run_model_stage(table, cfg, device="cpu")
    assert res.model_paths == {} and not (tmp_path / "hospital").exists()
    assert P.PipelineConfig().model_save_path == J.PipelineConfig().model_save_path


# ------------------------------------------ slice 5b: the five new classes

def _fit_5b(pkg, kind: str):
    """A small slice-5b model of ``kind`` fitted by ``pkg`` (P on the CPU)."""
    rng = np.random.default_rng(21)
    x = rng.normal(size=(160, 3)).astype(np.float32)
    on = {} if pkg is J else {"device": "cpu"}
    if kind == "GeneralizedLinearRegressionModel":
        y = rng.poisson(np.exp(x @ [0.3, -0.2, 0.1] + 0.5)).astype(np.float32)
        return pkg.GeneralizedLinearRegression(family="poisson", tol=1e-4).fit((x, y), **on)
    if kind == "MultilayerPerceptronModel":
        y = (x[:, 0] + x[:, 1] > 0).astype(np.float32)
        return pkg.MultilayerPerceptronClassifier(layers=(3, 4, 2), max_iter=5).fit((x, y), **on)
    if kind == "FMModel":
        y = (x @ [1.0, 0.5, -0.3]).astype(np.float32)
        return pkg.FMRegressor(max_iter=5, factor_size=2).fit((x, y), **on)
    if kind == "AFTSurvivalRegressionModel":
        t = np.exp(x @ [0.2, 0.1, -0.1] + 1.0).astype(np.float32)
        cen = (rng.random(160) < 0.7).astype(np.float32)
        return pkg.AFTSurvivalRegression(max_iter=5).fit((x, t), censor=cen, **on)
    y = (x[:, 1] + rng.normal(size=160) * 0.2).astype(np.float32)
    return pkg.IsotonicRegression(feature_index=1).fit((x, y), **on)


KINDS_5B = ["GeneralizedLinearRegressionModel", "MultilayerPerceptronModel", "FMModel",
            "AFTSurvivalRegressionModel", "IsotonicRegressionModel"]


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("kind", KINDS_5B)
def test_slice_5b_artifacts_cross_and_resave_to_the_same_bytes(kind, writer, tmp_path):
    first, other = (J, P) if writer == "jax" else (P, J)
    model = _fit_5b(first, kind)
    model.save(str(tmp_path / "a"))
    loaded = other.load_model(str(tmp_path / "a"))
    assert type(loaded).__name__ == kind
    loaded.save(str(tmp_path / "b"))
    _assert_same_files(str(tmp_path / "a"), str(tmp_path / "b"))
    x = np.random.default_rng(22).normal(size=(40, 3)).astype(np.float32)
    jm, pm = (model, loaded) if writer == "jax" else (loaded, model)
    got = pm.predict(torch.from_numpy(x)).numpy()
    # the same parameters; exp, sigmoid and the lerp differ in the last bit
    np.testing.assert_allclose(got, np.asarray(jm.predict(x)), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("kind", KINDS_5B)
def test_slice_5b_port_artifacts_have_the_reference_keys_dtypes_and_types(kind):
    jname, jparams, jarrays = _fit_5b(J, kind)._artifacts()
    pname, pparams, parrays = _fit_5b(P, kind)._artifacts()
    assert pname == jname == kind
    assert {k: type(v) for k, v in pparams.items()} == {k: type(v) for k, v in jparams.items()}
    assert {k: (v.dtype, v.shape) for k, v in parrays.items()} == \
        {k: (np.asarray(v).dtype, np.asarray(v).shape) for k, v in jarrays.items()}


# --------------------------------------- slice 5c: the feature stages' tags

FEATURE_COLS_5C = ("admission_count", "current_occupancy", "emergency_visits",
                   "seasonality_index")


def _rows_5c(n=240, seed=31):
    rng = np.random.default_rng(seed)
    cols = {"hospital_id": np.array([f"H{i:02d}" for i in rng.choice(4, n, p=[.4, .3, .2, .1])],
                                    dtype=object),
            "admission_count": rng.integers(0, 50, n).astype(np.float64),
            "current_occupancy": rng.integers(20, 400, n).astype(np.float64),
            "emergency_visits": rng.integers(0, 30, n).astype(np.float64),
            "seasonality_index": rng.uniform(0.5, 1.5, n)}
    cols["seasonality_index"][::17] = np.nan
    x = np.stack([cols[c] for c in FEATURE_COLS_5C], axis=1)
    cols["length_of_stay"] = np.nan_to_num(x) @ [0.05, 0.008, 0.12, 2.0] + rng.normal(0, 1, n)
    return cols


def _stage_5c(pkg, kind: str):
    """A slice-5c stage of ``kind`` built (and fitted) by ``pkg``."""
    on = {} if pkg is J else {"device": "cpu"}
    t = pkg.Table.from_dict(_rows_5c())
    x = np.nan_to_num(np.stack([_rows_5c()[c] for c in FEATURE_COLS_5C], 1)).astype(np.float32)
    return {
        "Bucketizer": lambda: pkg.QuantileDiscretizer(4, "admission_count", "b").fit(t),
        "StringIndexerModel": lambda: pkg.StringIndexer("hospital_id", "hid", "keep").fit(t),
        "OneHotEncoderModel": lambda: pkg.OneHotEncoder(["emergency_visits"], drop_last=False,
                                                        handle_invalid="keep").fit(t),
        "ImputerModel": lambda: pkg.Imputer(["seasonality_index"], ["s"], "median").fit(t),
        "IndexToString": lambda: pkg.IndexToString("admission_count", "a",
                                                   tuple(str(i) for i in range(50))),
        "RFormulaModel": lambda: pkg.RFormula(
            "length_of_stay ~ hospital_id + admission_count").fit(t),
        "SQLTransformer": lambda: pkg.SQLTransformer(
            "SELECT *, (admission_count + emergency_visits) AS ae FROM __THIS__"),
        "MinMaxScalerModel": lambda: pkg.MinMaxScaler(-1.0, 1.0).fit(x, **on),
        "MaxAbsScalerModel": lambda: pkg.MaxAbsScaler().fit(x, **on),
        "RobustScalerModel": lambda: pkg.RobustScaler(with_centering=True).fit(x, **on),
        "PCAModel": lambda: pkg.PCA(2).fit(x, **on),
        "Normalizer": lambda: pkg.Normalizer(1.0),
        "PolynomialExpansion": lambda: pkg.PolynomialExpansion(3),
        "VectorSlicer": lambda: pkg.VectorSlicer((3, 1)),
        "ElementwiseProduct": lambda: pkg.ElementwiseProduct((1.0, -2.0, 0.5, 4.0)),
        "Interaction": lambda: pkg.Interaction((0,), (2, 3)),
        "VectorSizeHint": lambda: pkg.VectorSizeHint(4),
    }[kind]()


KINDS_5C = ["Bucketizer", "StringIndexerModel", "OneHotEncoderModel", "ImputerModel",
            "IndexToString", "RFormulaModel", "SQLTransformer", "MinMaxScalerModel",
            "MaxAbsScalerModel", "RobustScalerModel", "PCAModel", "Normalizer",
            "PolynomialExpansion", "VectorSlicer", "ElementwiseProduct", "Interaction",
            "VectorSizeHint"]
TABLE_KINDS_5C = ("Bucketizer", "StringIndexerModel", "OneHotEncoderModel", "ImputerModel",
                  "IndexToString", "RFormulaModel", "SQLTransformer")


def _same_output_5c(kind: str, pm, jm):
    """The port stage ``pm`` and the JAX stage ``jm`` give equal outputs:
    the same host numpy on a Table, the same numpy on a matrix."""
    cols = _rows_5c(80, seed=32)
    if kind in TABLE_KINDS_5C:
        kw = {"device": "cpu"} if kind == "SQLTransformer" else {}
        got = pm.transform(P.Table.from_dict(cols), **kw)
        want = jm.transform(J.Table.from_dict(cols))
        if kind == "RFormulaModel":
            assert got.feature_cols == want.feature_cols
            got, want = got.table, want.table
        assert list(got.columns) == list(want.columns)
        for c in want.columns:
            np.testing.assert_array_equal(np.asarray(got.column(c)), np.asarray(want.column(c)))
        return
    x = np.nan_to_num(np.stack([cols[c] for c in FEATURE_COLS_5C], 1)).astype(np.float32)
    np.testing.assert_array_equal(pm.transform(x), jm.transform(x))


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("kind", KINDS_5C)
def test_slice_5c_artifacts_cross_and_resave_to_the_same_bytes(kind, writer, tmp_path):
    first, other = (J, P) if writer == "jax" else (P, J)
    model = _stage_5c(first, kind)
    (j_io if first is J else p_io).save_model(str(tmp_path / "a"), *model._artifacts())
    loaded = other.load_model(str(tmp_path / "a"))
    assert type(loaded).__name__ == type(model).__name__
    (p_io if other is P else j_io).save_model(str(tmp_path / "b"), *loaded._artifacts())
    _assert_same_files(str(tmp_path / "a"), str(tmp_path / "b"))
    pm, jm = (loaded, model) if writer == "jax" else (model, loaded)
    _same_output_5c(kind, pm, jm)


@pytest.mark.parametrize("kind", KINDS_5C)
def test_slice_5c_port_artifacts_have_the_reference_keys_dtypes_and_types(kind):
    jname, jparams, jarrays = _stage_5c(J, kind)._artifacts()
    pname, pparams, parrays = _stage_5c(P, kind)._artifacts()
    assert pname == jname
    assert pparams == jparams
    assert {k: (v.dtype, v.shape) for k, v in parrays.items()} == \
        {k: (np.asarray(v).dtype, np.asarray(v).shape) for k, v in jarrays.items()}


BRIDGES_5C = {
    "MinMaxScalerModel": P.minmax_scaler_model_from_jax_arrays,
    "MaxAbsScalerModel": P.maxabs_scaler_model_from_jax_arrays,
    "RobustScalerModel": P.robust_scaler_model_from_jax_arrays,
    "PCAModel": P.pca_model_from_jax_arrays,
    "ImputerModel": P.imputer_model_from_jax_arrays,
    "StringIndexerModel": P.string_indexer_model_from_jax_arrays,
    "OneHotEncoderModel": P.one_hot_encoder_model_from_jax_arrays,
    "RFormulaModel": P.rformula_model_from_jax_arrays,
}


@pytest.mark.parametrize("kind", sorted(BRIDGES_5C))
def test_slice_5c_in_memory_bridge_carries_the_jax_model(kind, tmp_path):
    jm = _stage_5c(J, kind)
    _, params, arrays = jm._artifacts()
    pm = BRIDGES_5C[kind](**arrays, **params)
    assert type(pm).__name__ == kind
    assert pm._artifacts()[1] == params
    _same_output_5c(kind, pm, jm)
    # the bridge builds what load_model builds from the JAX artifact
    j_io.save_model(str(tmp_path / "j"), *jm._artifacts())
    p_io.save_model(str(tmp_path / "p"), *pm._artifacts())
    _assert_same_files(str(tmp_path / "j"), str(tmp_path / "p"))


def _feature_pipeline(pkg):
    """StringIndexer → OneHotEncoder → VectorAssembler → MinMaxScaler →
    LogisticRegression on the hospital rows."""
    return pkg.Pipeline([
        pkg.Binarizer("length_of_stay", "LOS_binary", 4.0),
        pkg.StringIndexer("hospital_id", "hid"),
        pkg.OneHotEncoder(["hid"]),
        pkg.VectorAssembler(["hid_vec_0", "hid_vec_1", "hid_vec_2", *FEATURE_COLS_5C]),
        pkg.MinMaxScaler(),
        pkg.LogisticRegression(max_iter=30, tol=1e-3),
    ])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_slice_5c_pipeline_crosses_packages(writer, tmp_path):
    cols = _rows_5c(600, seed=33)
    cols["seasonality_index"] = np.nan_to_num(cols["seasonality_index"], nan=1.0)
    jt, pt_ = J.Table.from_dict(cols), P.Table.from_dict(cols)
    jm = _feature_pipeline(J).fit(jt)
    pm = _feature_pipeline(P).fit(pt_, device="cpu")
    # the table stages and the extremes are equal; the fit within the
    # binomial parity limit (tests/test_torch_logistic_regression.py)
    for s in (1, 2):
        assert pm.stages[s]._artifacts() == jm.stages[s]._artifacts()
    np.testing.assert_array_equal(pm.stages[4].data_min, jm.stages[4].data_min)
    np.testing.assert_array_equal(pm.stages[4].data_max, jm.stages[4].data_max)
    want = np.r_[np.asarray(jm.stages[5].coefficients), float(jm.stages[5].intercept)]
    got = np.r_[pm.stages[5].coefficients.numpy(), float(pm.stages[5].intercept)]
    np.testing.assert_allclose(got, want, atol=2e-5 * np.abs(want).max())
    saved, other = (jm, P) if writer == "jax" else (pm, J)
    saved.save(str(tmp_path / "pipe"))
    loaded = other.load_model(str(tmp_path / "pipe"))
    assert [type(s).__name__ for s in loaded.stages] == \
        [type(s).__name__ for s in saved.stages]
    if other is P:
        got = loaded.transform(pt_, device="cpu").to_numpy()[0]
        want = np.asarray(jm.transform(jt).to_numpy()[0])
    else:
        got = np.asarray(loaded.transform(jt).to_numpy()[0])
        want = pm.transform(pt_, device="cpu").to_numpy()[0]
    np.testing.assert_array_equal(got, want)


# ------------------------------------------- slices 5d + 5e: the new tags

def _docs_5de(n=120, seed=41):
    rng = np.random.default_rng(seed)
    topics = [[f"t{t}w{i}" for i in range(10)] for t in range(3)]
    return [list(rng.choice(topics[int(rng.integers(3))], 12)) + ["the", "of"]
            for _ in range(n)]


def _ratings_5de(seed=42):
    rng = np.random.default_rng(seed)
    mask = rng.uniform(size=(30, 20)) < 0.4
    uu, ii = np.nonzero(mask)
    return uu, ii, rng.normal(3.0, 1.0, len(uu)).astype(np.float32)


def _stage_5de(pkg, kind: str):
    """A slice-5d/5e stage or model of ``kind`` built (and fitted) by
    ``pkg``."""
    on = {} if pkg is J else {"device": "cpu"}
    cols = _rows_5c()
    x = np.nan_to_num(np.stack([cols[c] for c in FEATURE_COLS_5C], 1))
    cols["LOS_binary"] = (cols["length_of_stay"] > 4.0).astype(np.float64)
    asm = pkg.VectorAssembler(list(FEATURE_COLS_5C)).transform(
        pkg.Table.from_dict({**cols, "seasonality_index": x[:, 3]}))
    docs = _docs_5de()
    counts = J.CountVectorizer().fit(docs).transform(docs)
    return {
        "VectorIndexerModel": lambda: pkg.VectorIndexer(30, "keep").fit(asm),
        "UnivariateFeatureSelectorModel": lambda: pkg.UnivariateFeatureSelector(
            selection_threshold=2).fit(asm, **on),
        "VarianceThresholdSelectorModel": lambda: pkg.VarianceThresholdSelector(1.0).fit(x),
        "BucketedRandomProjectionLSHModel": lambda: pkg.BucketedRandomProjectionLSH(
            4.0, 3, seed=5).fit(x),
        "MinHashLSHModel": lambda: pkg.MinHashLSH(3, seed=5).fit((x > 20).astype(float) + 0),
        "Tokenizer": lambda: pkg.Tokenizer(),
        "RegexTokenizer": lambda: pkg.RegexTokenizer(r"\w+", gaps=False, min_token_length=2),
        "StopWordsRemover": lambda: pkg.StopWordsRemover(("the", "Of"), case_sensitive=True),
        "NGram": lambda: pkg.NGram(3),
        "CountVectorizerModel": lambda: pkg.CountVectorizer(min_df=2.0, min_tf=0.1).fit(docs),
        "HashingTF": lambda: pkg.HashingTF(64, binary=True),
        "IDFModel": lambda: pkg.IDF(2).fit(counts),
        "DCT": lambda: pkg.DCT(inverse=True),
        "Word2VecModel": lambda: pkg.Word2Vec(vector_size=8, min_count=2, batch_size=128).fit(
            docs, **on),
        "FeatureHasher": lambda: pkg.FeatureHasher(32),
        "ALSModel": lambda: pkg.ALS(rank=3, max_iter=3, cold_start_strategy="drop").fit(
            _ratings_5de(), **on),
        "LDAModel": lambda: pkg.LDA(k=3, max_iter=3, e_step_sweeps=20).fit(counts, **on),
        "FPGrowthModel": lambda: pkg.FPGrowth(0.2, 0.5).fit([d[:4] for d in docs]),
    }[kind]()


KINDS_5DE = ["VectorIndexerModel", "UnivariateFeatureSelectorModel",
             "VarianceThresholdSelectorModel", "BucketedRandomProjectionLSHModel",
             "MinHashLSHModel", "Tokenizer", "RegexTokenizer", "StopWordsRemover", "NGram",
             "CountVectorizerModel", "HashingTF", "IDFModel", "DCT", "Word2VecModel",
             "FeatureHasher", "ALSModel", "LDAModel", "FPGrowthModel"]


def _same_output_5de(kind: str, pm, jm):
    """The port stage ``pm`` and the JAX stage ``jm`` give equal outputs
    (within the parity tests' limits where a device computes)."""
    docs = _docs_5de(30, seed=43)
    x = np.nan_to_num(np.stack([_rows_5c(60, 44)[c] for c in FEATURE_COLS_5C], 1))
    if kind in ("Tokenizer", "RegexTokenizer"):
        texts = np.asarray([" ".join(d) + " The, OF!" for d in docs], dtype=object)
        assert [list(r) for r in pm.transform(texts)] == [list(r) for r in jm.transform(texts)]
    elif kind in ("StopWordsRemover", "NGram"):
        assert [list(r) for r in pm.transform(docs)] == [list(r) for r in jm.transform(docs)]
    elif kind in ("CountVectorizerModel", "HashingTF", "Word2VecModel"):
        np.testing.assert_array_equal(pm.transform(docs), jm.transform(docs))
    elif kind == "FeatureHasher":
        rows = [{"h": f"H{i % 3}", "v": float(i)} for i in range(10)]
        np.testing.assert_array_equal(pm.transform(rows), jm.transform(rows))
    elif kind == "IDFModel":
        tf = np.abs(np.round(np.random.default_rng(1).normal(size=(5, len(pm.idf)))))
        np.testing.assert_array_equal(pm.transform(tf), np.asarray(jm.transform(tf)))
    elif kind == "DCT":
        np.testing.assert_allclose(pm.transform(x, device="cpu").numpy(),
                                   np.asarray(jm.transform(x)), atol=2e-6 * np.abs(x).max())
    elif kind in ("BucketedRandomProjectionLSHModel", "MinHashLSHModel"):
        xs = (x > 20).astype(float) if kind == "MinHashLSHModel" else x
        np.testing.assert_array_equal(pm.hash_matrix(xs), jm.hash_matrix(xs))
    elif kind == "ALSModel":
        uu, ii, _ = _ratings_5de()
        np.testing.assert_array_equal(pm.predict(uu, ii), jm.predict(uu, ii))
        for g, w in zip(pm.recommend_for_all_users(4, device="cpu"),
                        jm.recommend_for_all_users(4)):
            np.testing.assert_array_equal(g, np.asarray(w))
    elif kind == "LDAModel":
        counts = J.CountVectorizer().fit(_docs_5de()).transform(docs)
        np.testing.assert_allclose(pm.transform(counts, device="cpu"), jm.transform(counts),
                                   atol=1e-6)
        assert [list(i) for i, _ in pm.describe_topics(5)] == \
            [list(i) for i, _ in jm.describe_topics(5)]
    elif kind == "FPGrowthModel":
        assert pm.transform(docs) == jm.transform(docs)
        assert pm.association_rules == jm.association_rules
    else:   # the indexer and the selectors: host numpy on a matrix
        np.testing.assert_array_equal(pm.transform(x), jm.transform(x))


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("kind", KINDS_5DE)
def test_slice_5de_artifacts_cross_and_resave_to_the_same_bytes(kind, writer, tmp_path):
    first, other = (J, P) if writer == "jax" else (P, J)
    model = _stage_5de(first, kind)
    (j_io if first is J else p_io).save_model(str(tmp_path / "a"), *model._artifacts())
    loaded = other.load_model(str(tmp_path / "a"))
    assert type(loaded).__name__ == type(model).__name__
    (p_io if other is P else j_io).save_model(str(tmp_path / "b"), *loaded._artifacts())
    _assert_same_files(str(tmp_path / "a"), str(tmp_path / "b"))
    pm, jm = (loaded, model) if writer == "jax" else (model, loaded)
    _same_output_5de(kind, pm, jm)


@pytest.mark.parametrize("kind", KINDS_5DE)
def test_slice_5de_port_artifacts_have_the_reference_keys_dtypes_and_types(kind):
    jname, jparams, jarrays = _stage_5de(J, kind)._artifacts()
    pname, pparams, parrays = _stage_5de(P, kind)._artifacts()
    assert pname == jname
    assert pparams == jparams
    assert {k: (v.dtype, v.shape) for k, v in parrays.items()} == \
        {k: (np.asarray(v).dtype, np.asarray(v).shape) for k, v in jarrays.items()}


BRIDGES_5DE = {
    "VectorIndexerModel": P.vector_indexer_model_from_jax_arrays,
    "UnivariateFeatureSelectorModel": P.univariate_feature_selector_model_from_jax_arrays,
    "VarianceThresholdSelectorModel": P.variance_threshold_selector_model_from_jax_arrays,
    "BucketedRandomProjectionLSHModel": P.bucketed_random_projection_lsh_model_from_jax_arrays,
    "MinHashLSHModel": P.minhash_lsh_model_from_jax_arrays,
    "CountVectorizerModel": P.count_vectorizer_model_from_jax_arrays,
    "IDFModel": P.idf_model_from_jax_arrays,
    "Word2VecModel": P.word2vec_model_from_jax_arrays,
    "ALSModel": P.als_model_from_jax_arrays,
    "LDAModel": P.lda_model_from_jax_arrays,
}


@pytest.mark.parametrize("kind", sorted(BRIDGES_5DE))
def test_slice_5de_in_memory_bridge_carries_the_jax_model(kind, tmp_path):
    jm = _stage_5de(J, kind)
    _, params, arrays = jm._artifacts()
    pm = BRIDGES_5DE[kind](**arrays, **params)
    assert type(pm).__name__ == kind
    assert pm._artifacts()[1] == params
    _same_output_5de(kind, pm, jm)
    j_io.save_model(str(tmp_path / "j"), *jm._artifacts())
    p_io.save_model(str(tmp_path / "p"), *pm._artifacts())
    _assert_same_files(str(tmp_path / "j"), str(tmp_path / "p"))
