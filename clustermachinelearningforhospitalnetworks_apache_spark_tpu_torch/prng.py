"""Threefry-2x32 counter-based draws, bit-equal to the JAX package's.

The JAX package draws its split permutation (``core/split.py``), the
per-node feature subsets and the Poisson bootstrap of its trees
(``models/tree/engine.py``) with ``jax.random`` under
``jax_threefry_partitionable=True``.  This module is the counterpart of
those calls in torch tensor ops, so the port draws the same numbers from
the same seeds:

* a key is a CPU ``int64`` tensor of shape ``(2,)`` holding two uint32
  words (``key(seed)`` = ``(0, seed mod 2**32)``, as jax without x64);
  ``fold_in`` and ``split`` are tiny and run on the host;
* ``random_bits`` / ``uniform`` / ``normal`` / ``permutation`` /
  ``poisson`` hash a counter per output element on the ``device`` the
  caller names, with the key words passed as Python scalars — so a draw on
  the card makes no host round trip.

``normal`` is not bit-equal to ``jax.random.normal``: it follows XLA's
``ErfInv32`` polynomial, but XLA's CPU ``log1p`` is its own approximation,
which torch does not reproduce.  Over 10**6 draws the two differ on about
1 % of the values, by at most 3 float32 ulp (``tests/test_torch_prng.py``).

uint32 words are held in ``int64`` tensors masked to 32 bits: torch has
no full uint32 arithmetic, and int64 holds every intermediate exactly.
"""

from __future__ import annotations

import math

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k1, k2, x1: torch.Tensor, x2: torch.Tensor):
    """The Threefry-2x32 hash (20 rounds) of counter words ``(x1, x2)``
    under key words ``(k1, k2)`` — ints or int64 tensors broadcastable to
    the counters, each in [0, 2**32).  → two int64 tensors of hash words."""
    ks = (k1, k2, (k1 ^ k2 ^ _PARITY))
    x1 = (x1 + ks[0]) & MASK32
    x2 = (x2 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = (x1 + x2) & MASK32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x1, x2


def key(seed: int) -> torch.Tensor:
    """``jax.random.key(seed)``'s two words: ``(0, seed mod 2**32)``."""
    return torch.tensor([0, int(seed) & MASK32], dtype=torch.int64)


def _words(k: torch.Tensor) -> tuple[int, int]:
    k = k.reshape(2)
    return int(k[0]) & MASK32, int(k[1]) & MASK32


def fold_in(k: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in``: the hash of counter ``(0, data)``."""
    k1, k2 = _words(k)
    c = torch.tensor([0, int(data) & MASK32], dtype=torch.int64)
    h1, h2 = threefry2x32(k1, k2, c[:1], c[1:])
    return torch.cat([h1, h2])


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` (fold-like, partitionable): key ``i`` is the
    hash of counter ``(0, i)``.  → (num, 2)."""
    k1, k2 = _words(k)
    idx = torch.arange(num, dtype=torch.int64)
    h1, h2 = threefry2x32(k1, k2, idx >> 32, idx & MASK32)
    return torch.stack([h1, h2], dim=1)


def random_bits(k: torch.Tensor, shape, device="cpu") -> torch.Tensor:
    """32 random bits per element of ``shape`` (``jax.random.bits``):
    the hash of each element's row-major flat index split into (hi, lo)
    words, XOR-folded.  → int64 tensor in [0, 2**32) on ``device``."""
    shape = tuple(int(s) for s in shape)
    idx = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    return bits_at(k, idx).reshape(shape)


def bits_at(k: torch.Tensor, flat_idx: torch.Tensor) -> torch.Tensor:
    """The bits ``random_bits`` gives at the row-major flat indices
    ``flat_idx`` (int64, on any device) of a draw under key ``k``."""
    k1, k2 = _words(k)
    h1, h2 = threefry2x32(k1, k2, flat_idx >> 32, flat_idx & MASK32)
    return h1 ^ h2


def _to_unit(bits: torch.Tensor) -> torch.Tensor:
    """32 bits → float32 in [0, 1): the top 23 bits become the mantissa of
    a float in [1, 2), minus 1 (``jax.random.uniform``)."""
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def uniform(k: torch.Tensor, shape, device="cpu") -> torch.Tensor:
    """float32 uniforms in [0, 1) (``jax.random.uniform``)."""
    return _to_unit(random_bits(k, shape, device))


#: XLA's ``ErfInv32`` coefficients (Giles), for w < 5 and w >= 5
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                 0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                 0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)
_F32 = np.float32
#: ``jax.random.normal`` draws its uniforms on [nextafter(-1, 0), 1)
_NORMAL_LO = float(np.nextafter(_F32(-1.0), _F32(0.0)))
_NORMAL_SCALE = float(_F32(1.0) - _F32(_NORMAL_LO))   # rounds to 2.0 in float32
_SQRT2 = float(_F32(np.sqrt(2.0)))


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """float32 inverse error function by XLA's ``ErfInv32``: Giles'
    polynomial in ``w = -log1p(-x²)`` (``w - 2.5`` below 5, ``√w - 3``
    above), evaluated by Horner with each step fused (computed in float64,
    rounded once, as an FMA does), times x; ``|x| == 1`` maps to ±max."""
    w = (-torch.log1p((-(x * x)).double())).float()
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0).double()

    def coef(i):   # Python scalars: no host-to-device copy
        return torch.where(small, _ERFINV_SMALL[i], _ERFINV_LARGE[i]).to(torch.float32)

    p = coef(0)
    for i in range(1, len(_ERFINV_SMALL)):
        p = (coef(i).double() + p.double() * w).float()
    return torch.where(x.abs() == 1.0, x * torch.finfo(torch.float32).max, p * x)


def _normal_from_bits(bits: torch.Tensor) -> torch.Tensor:
    u = _to_unit(bits) * _NORMAL_SCALE + _NORMAL_LO
    u = torch.clamp(u, min=_NORMAL_LO)
    return _SQRT2 * erf_inv(u)


def normal(k: torch.Tensor, shape, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """Standard normal float32 draws (``jax.random.normal``): uniforms on
    ``[nextafter(-1, 1), 1)`` through :func:`erf_inv`, times √2."""
    if dtype != torch.float32:
        raise NotImplementedError(f"normal draws float32 only, not {dtype}")
    return _normal_from_bits(random_bits(k, shape, device))


def normal_each(keys: torch.Tensor, shape, device="cpu") -> torch.Tensor:
    """One :func:`normal` draw of ``shape`` under each of the keys ``keys``
    (m, 2), stacked → (m, *shape) float32 on ``device``: row ``i`` equals
    ``normal(keys[i], shape)``, computed in one pass."""
    shape = tuple(int(s) for s in shape)
    kw = keys.reshape(-1, 2).to(torch.int64) & MASK32
    if torch.device(device).type == "cuda":
        # from pinned memory without blocking: no host sync
        kw = kw.pin_memory().to(device, non_blocking=True)
    idx = torch.arange(math.prod(shape), dtype=torch.int64, device=device)[None, :]
    h1, h2 = threefry2x32(kw[:, :1], kw[:, 1:], idx >> 32, idx & MASK32)
    return _normal_from_bits(h1 ^ h2).reshape((kw.shape[0], *shape))


def permutation(k: torch.Tensor, n: int, device="cpu") -> torch.Tensor:
    """``jax.random.permutation(k, n)``: ``ceil(3·ln n / ln(2**32 − 1))``
    rounds of a stable sort of ``arange(n)`` by fresh 32-bit keys.
    → int64 (n,) on ``device``."""
    x = torch.arange(n, dtype=torch.int64, device=device)
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(MASK32)))
    for _ in range(rounds):
        k, sub = split(k)
        sort_keys = random_bits(sub, (n,), device)
        order = torch.sort(sort_keys, stable=True).indices
        x = x[order]
    return x


def poisson(k: torch.Tensor, rate: float, shape, device="cpu") -> torch.Tensor:
    """``jax.random.poisson(k, rate, shape)`` for ``rate < 10`` (Knuth's
    branch) → int32 counts on ``device``.

    Each iteration splits the key once, counts the entries whose running
    ``Σ log u`` is still above ``−rate`` and adds ``log u`` of a fresh
    uniform draw over the whole shape.  An entry that is done never
    changes again, so only the live entries are drawn — at their flat
    indices, which gives them the bits the whole-shape draw would — and
    the loop ends when none is left (one host sync an iteration, to size
    the live set).  ``rate = 0`` gives zeros."""
    rate = float(rate)
    if not rate < 10.0:
        raise NotImplementedError(
            f"poisson rate {rate} >= 10 needs the rejection branch, which the "
            "port does not have yet (Spark's subsamplingRate lies in (0, 1])"
        )
    if rate < 0 or math.isnan(rate):
        raise ValueError(f"poisson rate must be >= 0, got {rate}")
    shape = tuple(int(s) for s in shape)
    neg_lam = -torch.tensor(rate, dtype=torch.float32).item()   # −rate in float32
    total = math.prod(shape)
    cnt = torch.zeros(total, dtype=torch.int32, device=device)
    if rate == 0.0 or total == 0:
        return cnt.reshape(shape)
    live = torch.arange(total, dtype=torch.int64, device=device)
    log_prod = torch.zeros(total, dtype=torch.float32, device=device)  # of the live
    while live.numel():
        k, sub = split(k)
        cnt[live] += 1
        log_prod = log_prod + torch.log(_to_unit(bits_at(sub, live)))
        keep = log_prod > neg_lam
        live, log_prod = live[keep], log_prod[keep]
    return (cnt - 1).reshape(shape)
