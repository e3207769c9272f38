"""The optimizers of the L-BFGS and Adam estimator families
(MultilayerPerceptronClassifier, AFTSurvivalRegression, the FMs).

The JAX package trains these families with ``optax.lbfgs()`` and
``optax.adam(lr)`` (optax 0.2.6).  This module takes the same steps with
torch tensors, so ``n_iter`` and the fitted parameters match:

- :class:`LBFGS` is ``optax.lbfgs()`` with its defaults: the two-loop
  recursion over a ring of 10 (s, y) pairs (a pair with sᵀy = 0 gets
  weight 0), the first direction scaled by min(1, 1/‖g‖) and later ones
  by sᵀy/yᵀy, ``scale(-1)``, and the zoom line search
  (``scale_by_zoom_linesearch(max_linesearch_steps=20,
  initial_guess_strategy="one")``): the interval search doubling from a
  step of 1, then cubic / quadratic / bisection interpolation, the
  sufficient-decrease test with Hager and Zhang's approximate-Wolfe
  alternative, the curvature test, and the safe step when it fails.
  The accepted point's value and gradient start the next iteration (as
  ``optax.value_and_grad_from_state``); nothing is evaluated twice.
- :func:`lbfgs_minimize` is the reference's loop around it: stop after
  ``max_iter`` iterations or when ``|prev − loss| ≤ tol·max(|loss|, 1)``.
- :class:`Adam` is ``optax.adam(lr)`` (b1 0.9, b2 0.999, eps 1e-8,
  eps_root 0), in optax's order of operations.

The parameters are a list of tensors, optax's pytree leaves in order: a
dot product or a norm is taken per leaf and then summed over the leaves
in that order (``optax.tree.vdot``).  Gradients come from
``torch.autograd.grad``; over a mesh, a shard at a time and summed in
ascending shard order (:func:`shard_value_and_grad`), so the line search
decides from the same summed bits on every rank of a process group.

The direction and its two-loop products stay on the device.  The line
search's decisions are scalar float32 arithmetic on the host (numpy
``float32``, the same IEEE single operations as the reference's traced
scalars), so each evaluation of the loss reads the host once (its value
and its slope along the direction, together) and each iteration once
more for the slope at its start; :attr:`LBFGS.host_reads` counts them.
"""

from __future__ import annotations

import numpy as np
import torch

f32 = np.float32

# optax's zoom line-search defaults (scale_by_zoom_linesearch)
SLOPE_RTOL = f32(1e-4)
CURV_RTOL = f32(0.9)
APPROX_DEC_RTOL = f32(1e-6)
APPROX_SLOPE = f32(2 * 1e-4 - 1.0)     # (2·slope_rtol − 1), formed in double as optax does
STEPSIZE_PRECISION = f32(1e-5)
INCREASE_FACTOR = f32(2.0)
LS_TOL = f32(0.0)
# optax.lbfgs()'s history and line-search length
MEMORY_SIZE = 10
MAX_LS = 20
# optax.adam's moments (eps_root is 0: it drops out of √(nu_hat + eps_root))
B1, B2, EPS = f32(0.9), f32(0.999), f32(1e-8)


def _vdot(a: list, b: list) -> torch.Tensor:
    """Σ over the leaves, in order, of each leaf's dot product."""
    out = None
    for x, y in zip(a, b):
        v = torch.dot(x.reshape(-1), y.reshape(-1))
        out = v if out is None else out + v
    return out


def _sqnorm(a: list) -> torch.Tensor:
    out = None
    for x in a:
        v = torch.sum(x * x)
        out = v if out is None else out + v
    return out


def _axpy(x: list, s, y: list) -> list:
    """``x + s·y`` leaf by leaf (two roundings, as optax's add_scale)."""
    return [xi + s * yi for xi, yi in zip(x, y)]


def value_and_grad(loss_fn, params: list):
    """(value, gradients) of ``loss_fn(params)``, detached."""
    ps = [p.detach().requires_grad_(True) for p in params]
    with torch.enable_grad():
        v = loss_fn(ps)
        g = torch.autograd.grad(v, ps)
    return v.detach(), [gi.detach() for gi in g]


def shard_value_and_grad(shard_sum, loss_of):
    """The (value, gradients) function of a loss that is a sum of per-shard
    terms: ``loss_of(i, shard)`` is data shard i's term as a function of
    the parameter list.  Each shard's value and gradient are taken on its
    device by :func:`value_and_grad` (its own leaves: shards that share a
    device share no ``.grad``), and ``shard_sum(fn)`` adds them over the
    shards in ascending order (``base.Shards.sum`` or
    ``outofcore.shard_sum``; one gather under a process group, so every
    rank reads the same bits).  One shard gives :func:`value_and_grad` of
    its term as it is."""
    def vg(params: list):
        def term(i, s):
            v, g = value_and_grad(loss_of(i, s), [p.to(s.x.device) for p in params])
            return (v, *g)

        out = shard_sum(term)
        return out[0], list(out[1:])

    return vg


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """optax's ``_cubicmin``: the critical point of the cubic through (a,
    fa), (b, fb), (c, fc) with slope fpa at a (NaN when there is none)."""
    C = fpa
    db = b - a
    dc = c - a
    t = db * dc
    denom = (t * t) * (db - dc)
    r0 = fb - fa - C * db
    r1 = fc - fa - C * dc
    A = (dc * dc * r0 + (-(db * db)) * r1) / denom
    B = ((-(dc * (dc * dc))) * r0 + db * (db * db) * r1) / denom
    radical = B * B - f32(3.0) * A * C
    return a + (-B + np.sqrt(radical)) / (f32(3.0) * A)


def _quadmin(a, fa, fpa, b, fb):
    """optax's ``_quadmin``: the critical point of the quadratic through
    (a, fa), (b, fb) with slope fpa at a."""
    db = b - a
    B = (fb - fa - fpa * db) / (db * db)
    return a - fpa / (f32(2.0) * B)


def _decrease_error(stepsize, value, slope, value_init, slope_init):
    err = value - value_init - SLOPE_RTOL * stepsize * slope_init
    approx = slope - APPROX_SLOPE * slope_init
    delta_values = value - value_init - APPROX_DEC_RTOL * np.abs(value_init)
    approx = np.maximum(approx, delta_values)
    err = np.maximum(np.minimum(approx, err), f32(0.0))
    return f32(np.inf) if np.isnan(err) else err


def _curvature_error(slope, slope_init):
    err = np.maximum(np.abs(slope) - CURV_RTOL * np.abs(slope_init), f32(0.0))
    return f32(np.inf) if np.isnan(err) else err


class LBFGS:
    """``optax.lbfgs()`` on a list of float32 tensors, one :meth:`step` an
    optax update.  After a step, ``learning_rate`` (the accepted step
    size), ``value`` (the loss there, host float32) and
    ``num_linesearch_steps`` read as optax's state does."""

    def __init__(self, loss_fn, params: list, grad_fn=None):
        self.grad_fn = grad_fn or (lambda ps: value_and_grad(loss_fn, ps))
        self.params = [p.detach().to(torch.float32) for p in params]
        self.count = 0
        self._prev_params = [torch.zeros_like(p) for p in self.params]
        self._prev_grad = [torch.zeros_like(p) for p in self.params]
        self._dw = [torch.zeros((MEMORY_SIZE,) + tuple(p.shape), dtype=p.dtype, device=p.device)
                    for p in self.params]
        self._du = [torch.zeros_like(d) for d in self._dw]
        self._rho = torch.zeros((MEMORY_SIZE,), dtype=torch.float32,
                                device=self.params[0].device)
        self.learning_rate = f32(1.0)
        self.value = f32(np.inf)          # the line search's accepted value (host)
        self._grad = None                 # ... and its gradient (device)
        self.num_linesearch_steps = 0
        self.evaluations = 0              # loss + gradient evaluations
        self.host_reads = 0

    def _read(self, *scalars) -> list:
        """One host read of device scalars, as float32."""
        self.host_reads += 1
        return [f32(v) for v in torch.stack([s.reshape(()) for s in scalars]).tolist()]

    def _evaluate(self, params: list):
        self.evaluations += 1
        return self.grad_fn(params)

    def _start(self) -> None:
        """optax's ``value_and_grad_from_state``: keep the line search's
        accepted value and gradient while the value is finite, else
        evaluate at the parameters (the first step always does)."""
        if self._grad is None or not np.isfinite(self.value):
            v, self._grad = self._evaluate(self.params)
            (self.value,) = self._read(v)

    # -- scale_by_lbfgs --------------------------------------------------
    def _direction(self, grad: list) -> list:
        m = MEMORY_SIZE
        mi, prev = self.count % m, (self.count - 1) % m
        dp = [p - q for p, q in zip(self.params, self._prev_params)]
        du = [g - q for g, q in zip(grad, self._prev_grad)]
        sy = _vdot(du, dp)
        zero = torch.zeros((), dtype=torch.float32, device=sy.device)
        weight = torch.where(sy == 0.0, zero, 1.0 / sy)
        if self.count == 0:
            dp = [torch.zeros_like(x) for x in dp]
            du = [torch.zeros_like(x) for x in du]
            weight = zero
        for mem, v in zip(self._dw, dp):
            mem[prev] = v
        for mem, v in zip(self._du, du):
            mem[prev] = v
        self._rho[prev] = weight
        if self.count > 0:
            num = _vdot(du, dp)
            den = _sqnorm(du)
            scale = torch.where(den > 0.0, num / den, torch.ones_like(num))
        else:
            scale = torch.clamp(1.0 / torch.sqrt(_sqnorm(grad)), max=1.0)
        idx = [(mi + j) % m for j in range(m)]
        vec = list(grad)
        alphas = [None] * m
        for j in reversed(range(m)):
            i = idx[j]
            a = self._rho[i] * _vdot([d[i] for d in self._dw], vec)
            vec = _axpy(vec, -a, [d[i] for d in self._du])
            alphas[j] = a
        vec = [scale * v for v in vec]
        for j in range(m):
            i = idx[j]
            b = self._rho[i] * _vdot([d[i] for d in self._du], vec)
            vec = _axpy(vec, alphas[j] - b, [d[i] for d in self._dw])
        self._prev_params = self.params
        self._prev_grad = list(grad)
        self.count += 1
        return vec

    # -- the zoom line search ---------------------------------------------
    def _line(self, params, updates, stepsize):
        """Value, gradient and slope at ``params + stepsize·updates``: one
        evaluation, one host read."""
        v, g = self._evaluate(_axpy(params, float(stepsize), updates))
        value, slope = self._read(v, _vdot(g, updates))
        return value, g, slope

    def _linesearch(self, params, updates, value, grad, slope):
        """``zoom_linesearch`` from its init to ``done | failed``; →
        (step size, value, gradient, steps)."""
        value_init, slope_init = value, slope
        st = dict(stepsize=f32(0.0), value=value, grad=grad, slope=slope,
                  dec=f32(np.inf), interval_found=False, done=False, failed=False,
                  low=f32(0.0), value_low=value, slope_low=slope,
                  high=f32(0.0), value_high=value, slope_high=slope,
                  cubic_ref=f32(0.0), value_cubic_ref=value,
                  safe_stepsize=f32(0.0), safe_value=value, safe_grad=grad)
        count = 0
        with np.errstate(all="ignore"):
            while not (st["done"] or st["failed"]):
                if st["interval_found"]:
                    self._zoom(st, count, params, updates, value_init, slope_init)
                else:
                    self._search(st, count, params, updates, value_init, slope_init)
                count += 1
                if st["failed"]:
                    # _try_safe_step
                    if st["safe_stepsize"] > 0.0 or np.isinf(st["dec"]):
                        st["stepsize"] = st["safe_stepsize"]
                        st["value"] = st["safe_value"]
                        st["grad"] = st["safe_grad"]
        return st["stepsize"], st["value"], st["grad"], count

    def _search(self, st, it, params, updates, value_init, slope_init):
        prev_stepsize, prev_value, prev_slope = st["stepsize"], st["value"], st["slope"]
        new = f32(1.0) if it == 0 else INCREASE_FACTOR * prev_stepsize
        value, grad, slope = self._line(params, updates, new)
        dec = _decrease_error(new, value, slope, value_init, slope_init)
        curv = _curvature_error(slope, slope_init)
        err = np.maximum(dec, curv)
        if dec <= LS_TOL:
            st.update(safe_stepsize=new, safe_value=value, safe_grad=grad)
        set_high = (dec > 0.0) or ((value >= prev_value) and it > 0)
        set_low = (slope >= 0.0) and not set_high
        if set_low:
            lo = (new, value, slope)
            hi = (prev_stepsize, prev_value, prev_slope)
        else:
            lo = (prev_stepsize, prev_value, prev_slope)
            hi = (new, value, slope)
        done = bool(err <= LS_TOL)
        st.update(stepsize=new, value=value, grad=grad, slope=slope, dec=dec,
                  interval_found=bool(set_high or set_low or done), done=done,
                  failed=(it + 1 >= MAX_LS) and not done,
                  low=lo[0], value_low=lo[1], slope_low=lo[2],
                  high=hi[0], value_high=hi[1], slope_high=hi[2],
                  cubic_ref=lo[0], value_cubic_ref=lo[1])

    def _zoom(self, st, it, params, updates, value_init, slope_init):
        low, value_low, slope_low = st["low"], st["value_low"], st["slope_low"]
        high, value_high, slope_high = st["high"], st["value_high"], st["slope_high"]
        delta = np.abs(high - low)
        left, right = np.minimum(high, low), np.maximum(high, low)
        cubic_chk, quad_chk = f32(0.2) * delta, f32(0.1) * delta
        too_small = delta <= STEPSIZE_PRECISION
        mc = _cubicmin(low, value_low, slope_low, high, value_high, st["cubic_ref"],
                       st["value_cubic_ref"])
        mq = _quadmin(low, value_low, slope_low, high, value_high)
        if (mc > left + cubic_chk) and (mc < right - cubic_chk):
            middle = mc
        elif (mq > left + quad_chk) and (mq < right - quad_chk):
            middle = mq
        else:
            middle = (low + high) / f32(2.0)
        value, grad, slope = self._line(params, updates, middle)
        dec = _decrease_error(middle, value, slope, value_init, slope_init)
        curv = _curvature_error(slope, slope_init)
        err = np.maximum(dec, curv)
        if dec <= LS_TOL and value < st["safe_value"]:
            st.update(safe_stepsize=middle, safe_value=value, safe_grad=grad)
        done = bool(err <= LS_TOL)
        set_high_to_middle = (dec > 0.0) or (value >= value_low)
        set_high_to_low = (slope * (high - low) >= 0.0) and not set_high_to_middle
        new_high = (middle, value, slope) if set_high_to_middle else (high, value_high, slope_high)
        if set_high_to_low:
            new_high = (low, value_low, slope_low)
        new_low = (low, value_low, slope_low) if set_high_to_middle else (middle, value, slope)
        ref = (high, value_high) if (set_high_to_middle or set_high_to_low) else (low, value_low)
        failed = ((it + 1 >= MAX_LS) or (too_small and st["safe_stepsize"] > 0.0)) \
            and not done
        st.update(stepsize=middle, value=value, grad=grad, slope=slope, dec=dec, done=done,
                  failed=bool(failed), low=new_low[0], value_low=new_low[1],
                  slope_low=new_low[2], high=new_high[0], value_high=new_high[1],
                  slope_high=new_high[2], cubic_ref=ref[0], value_cubic_ref=ref[1])

    def step(self):
        """One ``optax.lbfgs`` update and ``apply_updates``, from the value
        and gradient at the current parameters (:meth:`_start`).  → the
        host float32 value the line search accepted."""
        self._start()
        value, grad = self.value, self._grad
        updates = [-1.0 * d for d in self._direction(grad)]
        (slope,) = self._read(_vdot(updates, grad))
        lr, v, g, n = self._linesearch(self.params, updates, value, grad, slope)
        self.params = _axpy(self.params, float(lr), updates)
        self.learning_rate, self.value, self._grad = lr, v, g
        self.num_linesearch_steps = n
        return v


def lbfgs_minimize(loss_fn, params: list, max_iter: int, tol: float, grad_fn=None):
    """Minimize ``loss_fn`` over the list of tensors ``params`` with
    :class:`LBFGS`, the reference's loop: iterate while ``it < max_iter``
    and ``|prev − loss| > tol·max(|loss|, 1)`` (float32), ``prev`` the
    value where the iteration started and ``loss`` the value the line
    search accepted.  ``grad_fn(params) → (value, gradients)`` takes the
    place of ``loss_fn``'s autograd where given (a sharded loss:
    :func:`shard_value_and_grad`).  → (params, final loss, n_iter, the
    optimizer: its ``evaluations`` and ``host_reads``)."""
    opt = LBFGS(loss_fn, params, grad_fn)
    tol32 = f32(tol)
    opt._start()
    prev, loss = f32(np.inf), opt.value
    it = 0
    with np.errstate(all="ignore"):
        while it < max_iter and np.abs(prev - loss) > tol32 * np.maximum(np.abs(loss), f32(1.0)):
            opt._start()
            prev = opt.value
            loss = opt.step()
            it += 1
    return opt.params, loss, it, opt


def _pow_f32(x: np.float32, n: int) -> np.float32:
    """``x ** n`` rounded once to float32: the compiled XLA power of a
    float32 to a traced integer, which optax's bias correction takes
    inside the reference's jitted steps."""
    return f32(np.float64(x) ** n)


class Adam:
    """``optax.adam(lr)``: per leaf mu ← (1−b1)·g + b1·mu, nu ← (1−b2)·g² +
    b2·nu, the bias-corrected ratio mu_hat / (√nu_hat + eps), scaled by
    −lr and added to the parameters."""

    def __init__(self, params: list, lr: float):
        self.lr = float(f32(-1.0) * f32(lr))
        self.c1, self.c2 = float(f32(1 - 0.9)), float(f32(1 - 0.999))
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]

    def step(self, params: list, grads: list) -> list:
        """→ the updated parameters (new tensors)."""
        self.count += 1
        self.mu = [self.c1 * g + float(B1) * m for g, m in zip(grads, self.mu)]
        self.nu = [self.c2 * (g * g) + float(B2) * v for g, v in zip(grads, self.nu)]
        bc1 = float(f32(1.0) - _pow_f32(B1, self.count))
        bc2 = float(f32(1.0) - _pow_f32(B2, self.count))
        out = []
        for p, m, v in zip(params, self.mu, self.nu):
            u = (m / bc1) / (torch.sqrt(v / bc2) + float(EPS))
            out.append(p + self.lr * u)
        return out


__all__ = ["Adam", "LBFGS", "lbfgs_minimize", "shard_value_and_grad", "value_and_grad"]
