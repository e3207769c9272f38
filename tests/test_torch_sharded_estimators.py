"""The other estimators over a (data, model) mesh: the port's sharded
LinearSVC, GeneralizedLinearRegression, NaiveBayes, OneVsRest,
AFTSurvivalRegression, FMRegressor / FMClassifier,
MultilayerPerceptronClassifier and IsotonicRegression, resident and out of
core, against the port's own single-device fits and against the JAX
package's fits on the same mesh shape, on the CPU.

The port's meshes are over ``[torch.device("cpu")] * 8`` (each shard runs
K3's plain version inside OneVsRest's trees); the JAX side runs on
``tests/conftest.py``'s 8 virtual CPU devices through
``build_mesh(MeshConfig(data=D, model=M))``.

Tolerances, and why:
- a (1, 1) mesh is the single-device path: ``==`` everywhere;
- sums that are exact in float32 in any order give ``==`` on every mesh
  shape: NaiveBayes on integer counts (counts and Σx below 2**24),
  OneVsRest's trees (K3 histograms of 0/1 labels on integer rows) and
  IsotonicRegression (host PAVA over the same rows in the same order);
- every other fit sums float32 statistics a shard and then over the
  shards in ascending order, where the single-device fit sums per chunk of
  rows: against the single-device fit and against the JAX fit on the same
  mesh shape each is held at the JAX-parity tolerances of its own
  single-device test (``tests/test_torch_linear_svc.py``,
  ``test_torch_glm.py``, ``test_torch_naive_bayes.py``,
  ``test_torch_one_vs_rest.py``, ``test_torch_mlp_fm_aft.py``):
  LinearSVC and OneVsRest's logistic fits within 2e-5 of the largest
  coefficient; the GLM's coefficients within 2e-5 of the largest, deviance
  and the summary's sums within 1e-5 relative, standard errors 1e-4
  relative, response residuals within 1e-5 of the largest (the deviance
  residual's square root turns a float32-rounded unit deviance near 0
  into a gap of 3e-5 even on one device, so the smooth residual is the
  one compared), at tol 1e-4 where ``n_iter`` is the algorithm's (equal);
  gaussian NaiveBayes means within 1e-5 of the largest, variances rtol
  1e-4; AFT's (β, b, log σ) within 1e-5 of the largest with ``n_iter``
  equal; the MLP after 5 L-BFGS iterations within 1e-5 of the largest
  weight; the FMs after 30 Adam steps within 1e-4 of the largest
  parameter;
- out of core over (8, 1) against the JAX package's out-of-core fit on
  mesh8 (the same blocks: ``block_shape(mesh)`` rounds them to the data
  axis, and the minibatch fits draw the same block order), at the same
  limits; the one-device out-of-core fit is the (1, 1) case, ``==``.
"""

import numpy as np
import pytest
import torch

import clustermachinelearningforhospitalnetworks_apache_spark_tpu as J
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.config import (
    MeshConfig as JMeshConfig,
)
import clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch as port
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch import parallel as P

torch.set_num_threads(1)

CPU8 = [torch.device("cpu")] * 8
SHAPES = [(1, 1), (8, 1), (4, 2)]
N, D = 1200, 4
BLOCK = 256                       # the out-of-core fits: 5 blocks of 256 rows
COEF_TOL = 2e-5
REL_TOL = 1e-5
SE_RTOL = 1e-4
PARAM_TOL = 1e-5
FM_TOL = 1e-4


def _mesh(shape):
    return P.build_mesh(port.MeshConfig(data=shape[0], model=shape[1]), CPU8)


def _jmesh(shape):
    return J.parallel.build_mesh(JMeshConfig(data=shape[0], model=shape[1]))


def _rows(seed=0, n=N):
    """Float rows, a 0/1 label, a 0..2 label, positive LOS-like times,
    integer counts, and censor flags."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, D)) * [1.0, 2.0, 0.5, 1.0] + [0.0, 1.0, -1.0, 0.5]).astype(
        np.float32)
    s = x @ np.array([1.0, -0.5, 0.8, 0.3]) + rng.normal(0, 0.8, n)
    yb = (s > np.median(s)).astype(np.float32)
    y3 = np.digitize(s, np.quantile(s, [0.4, 0.75])).astype(np.float32)
    t = np.exp(0.3 * x[:, 0] - 0.2 * x[:, 1] + 1.0 + 0.4 * rng.normal(size=n)).astype(
        np.float32)
    counts = rng.poisson(2.0 + y3[:, None], size=(n, D)).astype(np.float32)
    cen = (rng.random(n) < 0.7).astype(np.float32)
    return x, yb, y3, t, counts, cen


def _np(v) -> np.ndarray:
    """A tensor or a (sharded) JAX array on the host, as float64."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v, np.float64)


def _scaled_close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


def _theta(m):
    return np.r_[_np(m.coefficients).ravel(), float(m.intercept)]


# --------------------------------------------------------------- LinearSVC
@pytest.mark.parametrize("shape", SHAPES)
def test_linear_svc_over_the_mesh(shape):
    x, yb, *_ = _rows()
    est = dict(reg_param=0.02)
    one = port.LinearSVC(**est).fit((x, yb), device="cpu")
    got = port.LinearSVC(**est).fit((x, yb), mesh=_mesh(shape))
    ref = J.LinearSVC(**est).fit((x, yb), mesh=_jmesh(shape))
    assert got.n_iter == ref.n_iter == one.n_iter
    _scaled_close(_theta(got), _theta(ref), COEF_TOL)
    _scaled_close(_theta(got), _theta(one), COEF_TOL)
    if shape == (1, 1):
        assert np.array_equal(_theta(got), _theta(one))


# ------------------------------------------------------------------- GLM
GLM_CASES = {
    "poisson": (dict(family="poisson"), lambda x, yb, t: np.round(t)),
    "gamma_log": (dict(family="gamma", link="log"), lambda x, yb, t: t),
    "binomial": (dict(family="binomial"), lambda x, yb, t: yb),
}


def _glm_table(pkg, x, y, offset):
    cols = {f"f{j}": x[:, j] for j in range(D)}
    cols.update(y=y, log_exposure=offset)
    return pkg.VectorAssembler([f"f{j}" for j in range(D)]).transform(pkg.Table.from_dict(cols))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("case", sorted(GLM_CASES))
def test_glm_over_the_mesh(shape, case):
    """Each family with an offset column (row-sharded as the rows are) and
    the summary's one pass over the shards."""
    kw, label = GLM_CASES[case]
    x, yb, _, t, *_ = _rows()
    y = label(x, yb, t).astype(np.float32)
    off = (0.1 * x[:, 2]).astype(np.float32)
    kw = dict(kw, tol=1e-4, label_col="y", offset_col="log_exposure")
    one = port.GeneralizedLinearRegression(**kw).fit(_glm_table(port, x, y, off), device="cpu")
    got = port.GeneralizedLinearRegression(**kw).fit(_glm_table(port, x, y, off),
                                                     mesh=_mesh(shape))
    ref = J.GeneralizedLinearRegression(**kw).fit(_glm_table(J, x, y, off), mesh=_jmesh(shape))
    assert got.n_iter == ref.n_iter == one.n_iter
    for want in (_theta(ref), _theta(one)):
        _scaled_close(_theta(got), want, COEF_TOL)
    for want in (ref, one):
        np.testing.assert_allclose(got.deviance, want.deviance, rtol=REL_TOL)
        for name in ("deviance", "null_deviance", "pearson_chi_squared", "aic"):
            np.testing.assert_allclose(getattr(got.summary, name), getattr(want.summary, name),
                                       rtol=REL_TOL)
        np.testing.assert_allclose(got.summary.coefficient_standard_errors,
                                   np.asarray(want.summary.coefficient_standard_errors),
                                   rtol=SE_RTOL)
        res = np.asarray(want.summary.residuals("response"))
        np.testing.assert_allclose(got.summary.residuals("response"), res, rtol=0,
                                   atol=REL_TOL * np.abs(res).max())
    if shape == (1, 1):
        assert np.array_equal(_theta(got), _theta(one)) and got.deviance == one.deviance
        assert got.summary.aic == one.summary.aic


# ------------------------------------------------------------- NaiveBayes
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("model_type", ["multinomial", "gaussian"])
def test_naive_bayes_over_the_mesh(shape, model_type):
    """Multinomial on integer counts is ``==`` one device on every shape;
    gaussian on float rows within its limits."""
    x, _, y3, _, counts, _ = _rows()
    xx = counts if model_type == "multinomial" else x
    est = port.NaiveBayes(model_type=model_type)
    one = est.fit((xx, y3), device="cpu")
    got = est.fit((xx, y3), mesh=_mesh(shape))
    ref = J.NaiveBayes(model_type=model_type).fit((xx, y3), mesh=_jmesh(shape))
    if model_type == "multinomial":
        assert np.array_equal(got.pi, one.pi) and np.array_equal(got.theta, one.theta)
        np.testing.assert_allclose(got.theta, ref.theta, rtol=1e-12)
        np.testing.assert_allclose(got.pi, ref.pi, rtol=1e-12)
        return
    for want in (ref, one):
        np.testing.assert_allclose(got.pi, want.pi, rtol=1e-6)
        _scaled_close(got.theta, want.theta, 1e-5)
        np.testing.assert_allclose(got.sigma, want.sigma, rtol=1e-4)
    if shape == (1, 1):
        assert np.array_equal(got.theta, one.theta) and np.array_equal(got.sigma, one.sigma)


# -------------------------------------------------------------- OneVsRest
@pytest.mark.parametrize("shape", SHAPES)
def test_one_vs_rest_over_the_mesh(shape):
    """Over trees on integer rows the three one-vs-all trees are ``==`` one
    device's (K3 once a data shard a level); over logistic the sharded
    Newton fits within 2e-5."""
    x, _, y3, *_ = _rows()
    xi = np.round(x * 2)
    mesh = _mesh(shape)
    tree = port.OneVsRest(port.DecisionTreeClassifier(max_depth=3))
    one, got = tree.fit((xi, y3), device="cpu"), tree.fit((xi, y3), mesh=mesh)
    ref = J.OneVsRest(J.DecisionTreeClassifier(max_depth=3)).fit((xi, y3), mesh=_jmesh(shape))
    for g, o, r in zip(got.models, one.models, ref.models):
        for name in ("split_feat", "threshold", "value"):
            assert np.array_equal(getattr(g, name), getattr(o, name))
        assert np.array_equal(g.split_feat, np.asarray(r.split_feat))
        np.testing.assert_allclose(g.value, np.asarray(r.value), atol=1e-6)
    pred = got.transform((xi, y3), mesh=mesh).to_numpy()[0]
    assert np.array_equal(pred, one.transform((xi, y3), device="cpu").to_numpy()[0])
    lr = port.OneVsRest(port.LogisticRegression())
    one, got = lr.fit((x, y3), device="cpu"), lr.fit((x, y3), mesh=mesh)
    ref = J.OneVsRest(J.LogisticRegression()).fit((x, y3), mesh=_jmesh(shape))
    for g, o, r in zip(got.models, one.models, ref.models):
        _scaled_close(_theta(g), _theta(r), COEF_TOL)
        _scaled_close(_theta(g), _theta(o), COEF_TOL)
        if shape == (1, 1):
            assert np.array_equal(_theta(g), _theta(o))


# ---------------------------------------------- AFT, the FMs and the MLP
@pytest.mark.parametrize("shape", SHAPES)
def test_aft_over_the_mesh(shape):
    """The censor column row-sharded as the rows are; the L-BFGS line
    search decides from the summed values and slopes."""
    x, _, _, t, _, cen = _rows()
    one = port.AFTSurvivalRegression(max_iter=30).fit((x, t), device="cpu", censor=cen)
    got = port.AFTSurvivalRegression(max_iter=30).fit((x, t), mesh=_mesh(shape), censor=cen)
    ref = J.AFTSurvivalRegression(max_iter=30).fit((x, t), mesh=_jmesh(shape), censor=cen)
    want = np.r_[np.asarray(ref.coefficients, np.float64), ref.intercept, np.log(ref.scale)]
    th = np.r_[got.coefficients, got.intercept, np.log(got.scale)]
    th1 = np.r_[one.coefficients, one.intercept, np.log(one.scale)]
    _scaled_close(th, want, PARAM_TOL)
    _scaled_close(th, th1, PARAM_TOL)
    assert got.fit_info["n_iter"] == one.fit_info["n_iter"]
    if shape == (1, 1):
        assert np.array_equal(th, th1) and got.fit_info == one.fit_info


def _fm_params(m):
    return np.r_[float(m.intercept), _np(m.linear).ravel(), _np(m.factors).ravel()]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kind", ["FMRegressor", "FMClassifier"])
def test_fm_over_the_mesh(shape, kind):
    """The penalty rides on data shard 0's term; 30 Adam steps."""
    x, yb, _, t, *_ = _rows()
    y = yb if kind == "FMClassifier" else t
    kw = dict(factor_size=3, max_iter=30, reg_param=0.01)
    one = getattr(port, kind)(**kw).fit((x, y), device="cpu")
    got = getattr(port, kind)(**kw).fit((x, y), mesh=_mesh(shape))
    ref = getattr(J, kind)(**kw).fit((x, y), mesh=_jmesh(shape))
    for want in (_fm_params(ref), _fm_params(one)):
        _scaled_close(_fm_params(got), want, FM_TOL)
    if shape == (1, 1):
        assert np.array_equal(_fm_params(got), _fm_params(one))


def _mlp_flat(m):
    return np.concatenate([_np(v).ravel() for wb in m.weights for v in wb])


@pytest.mark.parametrize("shape", SHAPES)
def test_mlp_over_the_mesh(shape):
    """After 5 L-BFGS iterations (a non-convex fit: see
    ``tests/test_torch_mlp_fm_aft.py`` for why longer fits are held by
    their outcome)."""
    x, _, y3, *_ = _rows()
    est = dict(layers=(D, 6, 3), max_iter=5, seed=0)
    one = port.MultilayerPerceptronClassifier(**est).fit((x, y3), device="cpu")
    got = port.MultilayerPerceptronClassifier(**est).fit((x, y3), mesh=_mesh(shape))
    ref = J.MultilayerPerceptronClassifier(**est).fit((x, y3), mesh=_jmesh(shape))
    for want in (_mlp_flat(ref), _mlp_flat(one)):
        _scaled_close(_mlp_flat(got), want, PARAM_TOL)
    assert got.fit_info["n_iter"] == one.fit_info["n_iter"]
    if shape == (1, 1):
        assert np.array_equal(_mlp_flat(got), _mlp_flat(one)) and got.fit_info == one.fit_info


@pytest.mark.parametrize("shape", SHAPES)
def test_isotonic_over_the_mesh(shape):
    """The shards' rows gathered in global row order: the same table as one
    device's and the JAX package's on every shape."""
    x, _, _, t, *_ = _rows()
    xr = np.round(x, 1)                       # ties pooled
    one = port.IsotonicRegression(feature_index=1).fit((xr, t), device="cpu")
    got = port.IsotonicRegression(feature_index=1).fit((xr, t), mesh=_mesh(shape))
    ref = J.IsotonicRegression(feature_index=1).fit((xr, t), mesh=_jmesh(shape))
    for want in (one, ref):
        assert np.array_equal(got.boundaries, np.asarray(want.boundaries))
        assert np.array_equal(got.predictions, np.asarray(want.predictions))


# ---------------------------------------------------------------- out of core
def _ooc_fits(name):
    """(port estimator, JAX estimator, data, fit kwargs) of each out-of-core
    case."""
    x, yb, y3, t, counts, cen = _rows(seed=3)
    cases = {
        "svc": (lambda m: m.LinearSVC(reg_param=0.02), x, yb, {}),
        "glm": (lambda m: m.GeneralizedLinearRegression(family="poisson", tol=1e-4), x,
                np.round(t), {}),
        "nb_multinomial": (lambda m: m.NaiveBayes(), counts, y3, {}),
        "nb_gaussian": (lambda m: m.NaiveBayes(model_type="gaussian"), x, y3, {}),
        # two blocks and depth 2: the JAX package's out-of-core trees take
        # seconds a block and a level on the CPU
        "ovr": (lambda m: m.OneVsRest(m.DecisionTreeClassifier(max_depth=2)), np.round(x * 2),
                y3, {}),
        "aft": (lambda m: m.AFTSurvivalRegression(max_iter=3), x, t, {"censor": cen}),
        "fm": (lambda m: m.FMRegressor(factor_size=3, max_iter=3), x, t, {}),
        "mlp": (lambda m: m.MultilayerPerceptronClassifier(layers=(D, 6, 3), max_iter=3), x, y3,
                {}),
        "isotonic": (lambda m: m.IsotonicRegression(), x, t, {}),
    }
    return cases[name]


def _params(name, m):
    """A fitted model's numbers as one float64 vector."""
    if name == "svc":
        return _theta(m)
    if name == "glm":
        return np.r_[_np(m.coefficients), m.intercept, m.deviance]
    if name.startswith("nb"):
        return np.r_[m.pi.ravel(), m.theta.ravel()] if m.sigma is None else \
            np.r_[m.pi.ravel(), m.theta.ravel(), m.sigma.ravel()]
    if name == "ovr":
        return np.concatenate([np.r_[np.asarray(t.threshold).ravel(), np.asarray(t.value).ravel()]
                               for t in m.models])
    if name == "aft":
        return np.r_[np.asarray(m.coefficients, np.float64), m.intercept, np.log(m.scale)]
    if name == "fm":
        return _fm_params(m)
    if name == "mlp":
        return _mlp_flat(m)
    return np.r_[m.boundaries, m.predictions]


#: (8, 1) against the JAX out-of-core fit on mesh8, of the largest value
OOC_TOL = {"svc": COEF_TOL, "glm": COEF_TOL, "nb_multinomial": 0.0, "nb_gaussian": 1e-4,
           "ovr": 1e-6, "aft": FM_TOL, "fm": FM_TOL, "mlp": FM_TOL, "isotonic": 0.0}


@pytest.mark.parametrize("name", sorted(OOC_TOL))
def test_out_of_core_over_the_mesh(name):
    make, x, y, kw = _ooc_fits(name)
    block = N // 2 if name == "ovr" else BLOCK
    hd = port.HostDataset(x=x, y=y.astype(np.float32), max_device_rows=block)
    one = make(port).fit(hd, device="cpu", **kw)
    m11 = make(port).fit(hd, mesh=_mesh((1, 1)), **kw)
    got = make(port).fit(hd, mesh=_mesh((8, 1)), **kw)
    ref = make(J).fit(J.HostDataset(x=x, y=y.astype(np.float32), max_device_rows=block),
                      mesh=_jmesh((8, 1)), **kw)
    assert np.array_equal(_params(name, m11), _params(name, one))
    want = _params(name, ref)
    _scaled_close(_params(name, got), want, OOC_TOL[name])
    if name in ("svc", "glm"):
        assert got.n_iter == ref.n_iter == one.n_iter
