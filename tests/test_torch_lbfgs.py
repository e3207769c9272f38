"""The port's optimizers (``models/_opt.py``) against optax 0.2.6, on the CPU.

``optax.lbfgs()`` is driven one update at a time (the JAX package's
``models/_opt.py`` loop body, jitted) and its state read after each:
``learning_rate`` (the accepted step size), ``value`` and
``info.num_linesearch_steps``.  The port's :class:`LBFGS` takes the same
updates on the same float32 inputs, made from a seed with numpy, on four
losses: a convex quadratic (d = 6, condition 1e3, two leaves), 2-D
Rosenbrock, the AFT loss (500 rows) and an MLP loss (layers (4, 8, 2), 300
rows, four leaves).

Tolerances, and why:
- over the first 5 iterations the line search takes the same number of
  evaluations (its decisions are float32 comparisons that no case here
  meets at a tie), the accepted step sizes agree within 1e-5 relative
  and the parameters within 1e-5 of the largest: the losses and
  gradients are float32 sums in another order (XLA's against torch's),
  and the iterates carry that rounding (Rosenbrock's fifth iterate sits
  3e-7 apart);
- the whole ``lbfgs_minimize`` run of the convex cases stops at the same
  ``n_iter`` with the final loss within 1e-6 relative, where the stop is
  the algorithm's: the quadratic at tol 1e-4 and 1e-3, the AFT loss at
  its tol 1e-6 and at 1e-4.  At tol 1e-6 the quadratic's plateau test
  compares loss changes of a few float32 ulps of |loss| ≈ 1.3, so
  rounding decides it (JAX 20 iterations, the port 22), as it does the
  AFT loss at 1e-9;
- Adam fed the same gradients within 1e-6 of the largest parameter after
  50 steps (1.5e-7 measured): the same float32 operations in optax's
  order, but XLA on the CPU contracts ``(1−b1)·g + b1·mu`` into one fused
  multiply-add, which torch rounds twice; each on its own gradients,
  within 1e-5 (the largest gap on the four losses is 5.3e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from clustermachinelearningforhospitalnetworks_apache_spark_tpu.models import _opt as jopt
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.models import mlp as jmlp
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.models import _opt as popt
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.models import aft as paft
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.models import mlp as pmlp

torch.set_num_threads(1)

STEPS = 5
LR_RTOL = 1e-5
PARAM_TOL = 1e-5


def _quadratic():
    rng = np.random.default_rng(0)
    q, _ = np.linalg.qr(rng.normal(size=(6, 6)))
    a = ((q * np.logspace(0, 3, 6)) @ q.T).astype(np.float32)
    b = rng.normal(size=6).astype(np.float32)
    x0 = rng.normal(size=6).astype(np.float32)
    aj, bj = jnp.asarray(a), jnp.asarray(b)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)

    def jloss(p):
        x = jnp.concatenate(p)
        return 0.5 * x @ (aj @ x) - bj @ x

    def ploss(p):
        x = torch.cat(p)
        return 0.5 * x @ (at @ x) - bt @ x

    return jloss, ploss, [x0[:4], x0[4:]]


def _rosenbrock():
    def loss(p):
        x = p[0]
        return (1 - x[0]) ** 2 + 100 * (x[1] - x[0] ** 2) ** 2

    return loss, loss, [np.array([-1.2, 1.0], np.float32)]


def _aft_data(n=500, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 3)).astype(np.float32)
    t = np.exp(x @ [0.3, -0.2, 0.1] + 1.0 + 0.5 * np.log(rng.exponential(size=n)))
    cen = (rng.random(n) < 0.7).astype(np.float32)
    return x, np.log(t.astype(np.float32)).astype(np.float32), cen


def _aft():
    x, logy, cen = _aft_data()
    d = x.shape[1]
    xj, lj, cj = jnp.asarray(x), jnp.asarray(logy), jnp.asarray(cen)
    w = np.ones(x.shape[0], np.float32)

    def jloss(p):   # the reference's _fit_aft loss, word for word
        theta = p[0]
        wsum = jnp.maximum(jnp.sum(jnp.asarray(w)), 1.0)
        beta, b, log_sigma = theta[:d], theta[d], theta[-1]
        z = (lj - xj @ beta - b) / jnp.exp(log_sigma)
        ez = jnp.exp(z)
        ll = jnp.where(cj > 0, -log_sigma + z - ez, -ez)
        return -jnp.sum(ll * jnp.asarray(w)) / wsum

    ploss = paft.aft_loss(torch.from_numpy(x), torch.from_numpy(logy), torch.from_numpy(cen),
                          torch.from_numpy(w), True)
    return jloss, ploss, [np.zeros(d + 2, np.float32)]


def _mlp_data(n=300, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 4)).astype(np.float32)
    y = (x[:, 0] + 0.5 * x[:, 1] ** 2 - x[:, 2] * x[:, 3] + rng.normal(size=n) * 0.5 > 0.3)
    return x, y.astype(np.float32)


def _mlp():
    x, y = _mlp_data()
    w = np.ones(x.shape[0], np.float32)
    xj, yi = jnp.asarray(x), jnp.asarray(y).astype(jnp.int32)

    def jloss(p):   # the reference's _fit_lbfgs loss on [W0, b0, W1, b1]
        params = [(p[0], p[1]), (p[2], p[3])]
        ll = jax.nn.log_softmax(jmlp._forward(params, xj), axis=1)
        nll = -jnp.take_along_axis(ll, yi[:, None], axis=1)[:, 0]
        return jnp.sum(nll * jnp.asarray(w)) / jnp.maximum(jnp.sum(jnp.asarray(w)), 1.0)

    ploss = pmlp.mlp_loss(torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(w))
    init = [t.numpy() for t in pmlp.init_params((4, 8, 2), 0, "cpu")]
    return jloss, ploss, init


CASES = {"quadratic": _quadratic, "rosenbrock": _rosenbrock, "aft": _aft, "mlp": _mlp}


def _optax_steps(loss, params, n):
    """optax.lbfgs() one update at a time → [(lr, value, ls steps, leaves)]."""
    opt = optax.lbfgs()
    params = [jnp.asarray(p) for p in params]
    state = opt.init(params)
    vag = optax.value_and_grad_from_state(loss)

    @jax.jit
    def step(p, st):
        v, g = vag(p, state=st)
        u, st = opt.update(g, st, p, value=v, grad=g, value_fn=loss)
        return optax.apply_updates(p, u), st

    out = []
    for _ in range(n):
        params, state = step(params, state)
        out.append((float(optax.tree.get(state, "learning_rate")),
                    float(optax.tree.get(state, "value")),
                    int(optax.tree.get(state, "num_linesearch_steps")),
                    [np.asarray(p) for p in params]))
    return out


def _port_steps(loss, params, n):
    opt = popt.LBFGS(loss, [torch.from_numpy(p.copy()) for p in params])
    out = []
    for _ in range(n):
        opt.step()
        out.append((float(opt.learning_rate), float(opt.value), opt.num_linesearch_steps,
                    [p.numpy() for p in opt.params]))
    return out, opt


@pytest.mark.parametrize("case", list(CASES))
def test_first_steps_match_optax(case):
    jloss, ploss, init = CASES[case]()
    want = _optax_steps(jloss, init, STEPS)
    got, opt = _port_steps(ploss, init, STEPS)
    for i, (w, g) in enumerate(zip(want, got)):
        assert g[2] == w[2], f"iteration {i + 1}: line-search steps {g[2]} != {w[2]}"
        assert abs(g[0] - w[0]) <= LR_RTOL * abs(w[0]), f"iteration {i + 1}: step size"
        scale = max(np.abs(p).max() for p in w[3])
        gap = max(np.abs(a - b).max() for a, b in zip(w[3], g[3]))
        assert gap <= PARAM_TOL * scale, f"iteration {i + 1}: parameters {gap:.3g} apart"
    # the start, then one evaluation a line-search step; one host read an
    # evaluation and one a step (the slope along its direction)
    assert opt.evaluations == 1 + sum(s[2] for s in got)
    assert opt.host_reads == opt.evaluations + STEPS


def _jax_minimize(loss, init, max_iter, tol):
    fn = jax.jit(lambda p: jopt.lbfgs_minimize(loss, p, max_iter, tol))
    p, val, it = fn([jnp.asarray(v) for v in init])
    return [np.asarray(v) for v in p], float(val), int(it)


@pytest.mark.parametrize("case,tol", [("quadratic", 1e-4), ("quadratic", 1e-3), ("aft", 1e-6),
                                      ("aft", 1e-4)])
def test_convex_runs_stop_at_the_same_iteration(case, tol):
    jloss, ploss, init = CASES[case]()
    jp, jv, jit_ = _jax_minimize(jloss, init, 100, tol)
    pp, pv, pit, opt = popt.lbfgs_minimize(ploss, [torch.from_numpy(v.copy()) for v in init],
                                           100, tol)
    assert pit == jit_ and 1 < pit < 100
    assert abs(float(pv) - jv) <= 1e-6 * abs(jv)
    assert opt.host_reads == opt.evaluations + pit


def test_max_iter_and_a_non_finite_start_stop_the_loop():
    _, ploss, init = _quadratic()
    _, _, it, _ = popt.lbfgs_minimize(ploss, [torch.from_numpy(v.copy()) for v in init], 3, 0.0)
    assert it == 3
    nan_start = [torch.full((2,), float("nan"))]
    _, loss, it, _ = popt.lbfgs_minimize(lambda p: torch.sum(p[0] ** 2), nan_start, 10, 1e-6)
    assert it == 0 and np.isnan(loss)   # |inf − NaN| > tol is false, as in the reference


@pytest.mark.parametrize("lr", [1e-2, 5e-2])
def test_adam_on_the_same_gradients_matches_optax_after_50_steps(lr):
    jloss, _, init = _mlp()
    opt = optax.adam(lr)
    jp = [jnp.asarray(p) for p in init]
    st = opt.init(jp)
    grad = jax.jit(jax.grad(jloss))
    update = jax.jit(opt.update)        # jitted, as the reference's steps
    pp = [torch.from_numpy(p.copy()) for p in init]
    padam = popt.Adam(pp, lr)
    for _ in range(50):
        g = grad(jp)
        u, st = update(g, st)
        jp = optax.apply_updates(jp, u)
        pp = padam.step(pp, [torch.from_numpy(np.asarray(v).copy()) for v in g])
    scale = max(float(np.abs(np.asarray(p)).max()) for p in jp)
    gap = max(np.abs(np.asarray(a) - b.numpy()).max() for a, b in zip(jp, pp))
    assert gap <= 1e-6 * scale


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("lr", [1e-2, 5e-2])
def test_adam_matches_optax_after_50_steps(case, lr):
    # each side on its own gradients, which differ in their last bits; Adam
    # divides by √v, so a coordinate whose gradient nears 0 carries that
    # difference: 5.3e-6 of the largest parameter at most on these losses
    jloss, ploss, init = CASES[case]()
    opt = optax.adam(lr)
    jp = [jnp.asarray(p) for p in init]
    st = opt.init(jp)
    step = jax.jit(lambda p, s: opt.update(jax.grad(jloss)(p), s))
    pp = [torch.from_numpy(p.copy()) for p in init]
    padam = popt.Adam(pp, lr)
    for _ in range(50):
        u, st = step(jp, st)
        jp = optax.apply_updates(jp, u)
        _, g = popt.value_and_grad(ploss, pp)
        pp = padam.step(pp, g)
    scale = max(float(np.abs(np.asarray(p)).max()) for p in jp)
    gap = max(np.abs(np.asarray(a) - b.numpy()).max() for a, b in zip(jp, pp))
    assert gap <= 1e-5 * scale


def test_bias_correction_power_is_the_compiled_xla_power():
    # optax's 1 − b**count with count traced, as in every jitted step of
    # the reference: XLA's power rounds once (outside jit, jnp.power of a
    # concrete integer squares repeatedly and differs in the last bit)
    power = jax.jit(lambda c, d: 1 - d ** c, static_argnums=1)
    for decay in (0.9, 0.999):
        for count in range(1, 301):
            want = np.float32(power(jnp.asarray(count, jnp.int32), decay))
            assert np.float32(1) - popt._pow_f32(np.float32(decay), count) == want
