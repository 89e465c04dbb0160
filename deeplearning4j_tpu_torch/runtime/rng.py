"""Counter-based random bits — the counterpart of
`deeplearning4j_tpu/runtime/rng.py`'s keys, giving the same bits as
`jax.random` with its default threefry generator.

jax 0.9.0 draws with ``threefry2x32`` (Salmon et al., "Parallel random
numbers: as easy as 1, 2, 3", SC 2011: 20 rounds, a key injection every
4) in the partitionable layout (``jax_threefry_partitionable = True``):
element i of a ``shape`` (row-major flat index, as a 64-bit count split
into hi and lo 32-bit words) gets ``x0 ^ x1`` of
``threefry2x32(key, (hi(i), lo(i)))``.  So the bits of one element do not
depend on the shape around it: ``(1, V)`` and ``(V,)`` agree.

The bits are integer arithmetic on int64 tensors holding 32-bit words
(every add and shift masked back to 32 bits), the floats made from them
f32 arithmetic in jax's order, so it runs on any device and needs no
jax.

- `key(seed)`, `fold_in(key, data)`: a key is a 2-tuple of Python ints
  (the two 32-bit words of ``jax.random.key_data``).
- `random_bits(key, shape)`: uint32 bits as an int64 tensor;
  `bits_at(key, index)` the same bits for chosen flat indices only.
- `uniform(key, shape, minval, maxval)`: f32, jax's mantissa trick.
- `gumbel(key, shape)`: f32 standard Gumbel in jax's mode "low";
  `gumbel_at(key, index)` its values at chosen flat indices, on the host.
- `split(key, n)`: jax's partitionable split, subkey i the two words of
  ``threefry2x32(key, (hi(i), lo(i)))``.
- `normal(key, shape)`: f32 ``jax.random.normal``, sqrt(2) erfinv(u) of
  a uniform u on (nextafter(-1, 0), 1), with XLA's erfinv (below).
- `bernoulli(key, p, shape)`: ``uniform < p``.
- `SeedStream`: named (``init/<layer>``) and sequential subkeys of one
  root seed, and the per-step fold that dropout draws from.

XLA's CPU backend contracts a product feeding a single add into one
fused multiply-add (uniform's scale and shift, the polynomials of log
and erfinv); `_fma` gives that single rounding on any device.  Every
other operation is one f32 rounding, as XLA's.  `normal` equals
``jax.random.normal`` bit for bit on all 2^23 uniform values it can
draw (the tests hold every one).
"""

from __future__ import annotations

import math

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_TINY = torch.finfo(torch.float32).tiny


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0: int, k1: int, x0, x1):
    """The Threefry-2x32 block function of key (k0, k1) on counts
    (x0, x1): int64 tensors or numpy arrays of 32-bit words, or Python
    ints, one shape.  Returns the two output words."""
    ks = (k0 & _M32, k1 & _M32, (k0 ^ k1 ^ _PARITY) & _M32)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def key(seed: int) -> tuple[int, int]:
    """``jax.random.key(seed)``'s data: the seed's high and low 32-bit
    words.  A seed in the int32 range has a high word of 0 (jax holds
    it as int32 without x64); a negative one wraps in its low word."""
    seed = int(seed)
    hi = 0 if -2**31 <= seed < 2**31 else (seed >> 32) & _M32
    return hi, seed & _M32


def fold_in(k: tuple[int, int], data: int) -> tuple[int, int]:
    """``jax.random.fold_in``: the key hashed with the count
    ``(0, data)``, data taken as uint32."""
    return threefry2x32(k[0], k[1], 0, int(data) & _M32)


def bits_at(k: tuple[int, int], index):
    """The 32 random bits of the elements at int64 flat indices ``index``
    (a tensor or a numpy array) of any shape drawn with key ``k``
    (element i's bits depend on i alone), as int64 values in [0, 2^32)
    of index's type."""
    x0, x1 = threefry2x32(k[0], k[1], index >> 32, index & _M32)
    return x0 ^ x1


def random_bits(k: tuple[int, int], shape, device=None, offset: int = 0) -> torch.Tensor:
    """32 random bits for each element of ``shape``, as an int64 tensor
    of values in [0, 2^32).  ``offset``: the flat index of the first
    element in a larger tensor drawn with ``k`` (a rank's rows of a
    global shape), or an int64 tensor of ``shape`` holding each
    element's flat index there (a rank's time block)."""
    if isinstance(offset, torch.Tensor):
        return bits_at(k, offset.reshape(-1)).reshape(shape)
    n = math.prod(shape)
    i = torch.arange(offset, offset + n, dtype=torch.int64, device=device)
    return bits_at(k, i).reshape(shape)


def _uniform(bits: torch.Tensor, minval: float, maxval: float) -> torch.Tensor:
    one = (bits >> 9) | 0x3F800000
    floats = one.to(torch.int32).view(torch.float32) - 1.0
    lo, hi = (torch.tensor(x, dtype=torch.float32) for x in (minval, maxval))
    return torch.clamp_min(_fma(floats, (hi - lo).item(), lo.item()), lo.item())


def uniform(k: tuple[int, int], shape, minval: float = 0.0, maxval: float = 1.0,
            device=None, offset: int = 0) -> torch.Tensor:
    """f32 uniform on [minval, maxval): the top 23 bits as the mantissa of
    a float in [1, 2), minus 1, scaled, and held at minval or above."""
    return _uniform(random_bits(k, shape, device, offset), minval, maxval)


def _f32(v: float) -> float:
    return torch.tensor(v, dtype=torch.float32).item()


# Cephes' log polynomial, as Eigen's `plog` and XLA's CPU backend evaluate it
_SQRTHF = _f32(0.707106781186547524)
_LOG_P = [_f32(v) for v in (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
                            -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
                            2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)]
_LOG_Q1, _LOG_Q2 = _f32(-2.12194440e-4), _f32(0.693359375)


def _fma(a, b, c):
    """f32 ``a * b + c`` rounded once, as a fused multiply-add: the
    product of two f32 values is exact in f64; their f64 sum is made
    round-to-odd (from its exact error, Knuth's two-sum), and an f64
    rounded to odd rounds to the correctly rounded f32.  ``a`` is a
    tensor; ``b`` and ``c`` tensors or Python floats holding f32 values."""
    a, b, c = (x.double() if isinstance(x, torch.Tensor) else x
               for x in (a, b, c))
    p = a * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)        # s + err == p + c exactly
    bits = s.view(torch.int64)
    away = (err > 0) == (s > 0)            # the exact sum lies beyond s
    nudge = torch.where(away, bits + 1, bits - 1)
    bits = torch.where((err != 0) & ((bits & 1) == 0), nudge, bits)
    return bits.view(torch.float64).float()


def _log(x: torch.Tensor) -> torch.Tensor:
    """f32 natural log of positive normal x, the polynomial jax's CPU
    backend evaluates (`torch.log` rounds otherwise in about one input
    of seven), so that `gumbel` gives jax's bits: x = m 2^e with m in
    [sqrt(1/2), sqrt(2)), log(1 + (m - 1)) by a degree-9 polynomial."""
    bits = x.view(torch.int32)
    e = ((bits >> 23) & 0xFF).float() - 126.0
    m = ((bits & 0x007FFFFF) | 0x3F000000).view(torch.float32)   # [0.5, 1)
    small = m < _SQRTHF
    x = (m - 1.0) + torch.where(small, m, 0.0)
    e = e - small.float()
    x2 = x * x
    x3 = x2 * x
    p = _LOG_P
    y = _fma(_fma(p[0], x, p[1]), x, p[2])
    y1 = _fma(_fma(p[3], x, p[4]), x, p[5])
    y2 = _fma(_fma(p[6], x, p[7]), x, p[8])
    y = _fma(_fma(y, x3, y1), x3, y2)
    y = _fma(y, x3, e * _LOG_Q1)
    return (x - x2 * 0.5) + y + e * _LOG_Q2


def _gumbel(bits: torch.Tensor) -> torch.Tensor:
    # both logs see positive normal floats only (u < 1, -log(u) >= 2^-23)
    return -_log(-_log(_uniform(bits, _TINY, 1.0)))


def gumbel(k: tuple[int, int], shape, device=None) -> torch.Tensor:
    """f32 standard Gumbel noise, ``-log(-log(u))`` with u uniform on
    [tiny, 1): jax's mode "low"."""
    return _gumbel(random_bits(k, shape, device))


def gumbel_at(k: tuple[int, int], index: torch.Tensor) -> torch.Tensor:
    """`gumbel`'s values at the int64 flat indices of the CPU tensor
    ``index`` only, drawn on the host: threefry runs on its numpy array,
    whose ~170 array operations on a handful of elements cost a tenth of
    as many torch calls."""
    return _gumbel(torch.from_numpy(bits_at(k, index.numpy())))


def split(k: tuple[int, int], n: int = 2) -> list[tuple[int, int]]:
    """``jax.random.split(key, n)`` in jax's partitionable layout: subkey
    i is the two output words of threefry on the 64-bit count i."""
    return [threefry2x32(k[0], k[1], i >> 32, i & _M32) for i in range(n)]


# XLA's f32 erfinv (Giles, "Approximating the erfinv function", GPU Gems
# 4, 2011): w = -log1p(-x^2), a degree-8 polynomial in w - 2.5 below
# w = 5 and in sqrt(w) - 3 above
_ERFINV_LT5 = [_f32(v) for v in (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
    0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)]
_ERFINV_GE5 = [_f32(v) for v in (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
    0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)]
# XLA's log1p below |x| = sqrt(2) - 1: x - x^2 / 2 + x^3 P(x) / Q(x)
# (Cephes' rational approximation), log(1 + x) above
_LOG1P_P = [_f32(v) for v in (
    4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
    6.5787325942061044846969e0, 2.9911919328553073277375e1,
    6.0949667980987787057556e1, 5.7112963590585538103336e1,
    2.0039553499201281259648e1)]
_LOG1P_Q = [_f32(v) for v in (
    1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
    2.2176239823732856465394e2, 3.0909872225312059774938e2,
    2.1642788614495947685003e2, 6.0118660497603843919306e1)]
_SQRT2 = _f32(math.sqrt(2.0))


def _horner(x: torch.Tensor, coeffs) -> torch.Tensor:
    p = torch.full_like(x, coeffs[0])
    for c in coeffs[1:]:
        p = _fma(p, x, c)
    return p


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    # correctly rounded: the CPU's vectorised f32 sqrt is not, and an f64
    # square root of an f32 rounds to the right f32
    return torch.sqrt(x.double()).float()


def _log1p_of_negative_square(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``log1p(-x * x)`` for x in (-1, 1)."""
    t = x * -x
    big = _log(t + 1.0)
    t2 = t * t
    small = t + (t2 * -0.5 + (t * t2) * (_horner(t, _LOG1P_P)
                                          / _horner(t, _LOG1P_Q)))
    return torch.where(t.abs() < _f32(math.sqrt(2.0) - 1.0), small, big)


def _erfinv(x: torch.Tensor) -> torch.Tensor:
    w = -_log1p_of_negative_square(x)
    lt = w < 5.0
    s = torch.where(lt, w - 2.5, _sqrt(w) - 3.0)
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0])
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = _fma(p, s, torch.where(lt, a, b))
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def normal(k: tuple[int, int], shape, device=None) -> torch.Tensor:
    """f32 standard normal: sqrt(2) erfinv(u), u uniform on
    (nextafter(-1, 0), 1) — ``jax.random.normal``."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    return _SQRT2 * _erfinv(_uniform(random_bits(k, shape, device), lo, 1.0))


def bernoulli(k: tuple[int, int], p: float, shape, device=None,
              offset: int = 0) -> torch.Tensor:
    """bool tensor, True where a uniform draw is below ``p`` (taken as
    f32) — ``jax.random.bernoulli``; ``offset`` as in `random_bits`."""
    return uniform(k, shape, device=device, offset=offset) < _f32(p)


def _stable_hash(name: str) -> int:
    """FNV-1a of the name's bytes, held to 31 bits: the JAX package's
    name hash (Python's `hash` is salted per process)."""
    h = 0xCBF29CE484222325
    for b in name.encode():
        h = ((h ^ b) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h & 0x7FFFFFFF


class SeedStream:
    """Subkeys of one root seed, as the JAX package's `SeedStream` hands
    them out:

    - ``stream.key(name)``: a stable named key (``init/<layer name>``);
    - ``stream.next()``: sequential keys, 1, 2, ... folded into the root;
    - ``SeedStream.fold(key, step)``: the key of a training step.

    ``seed`` is an int or a key's two 32-bit words."""

    def __init__(self, seed=0):
        if isinstance(seed, (tuple, list, np.ndarray)):
            words = [int(w) for w in np.asarray(seed).reshape(-1)]
            if len(words) != 2:
                raise TypeError(f"a key has two 32-bit words, got {seed!r}")
            self._key = (words[0] & _M32, words[1] & _M32)
        else:
            self._key = key(seed)
        self._count = 0

    @property
    def root(self) -> tuple[int, int]:
        return self._key

    def key(self, name: str) -> tuple[int, int]:
        return fold_in(self._key, _stable_hash(name))

    def next(self) -> tuple[int, int]:
        self._count += 1
        return fold_in(self._key, self._count)

    def state_dict(self) -> dict:
        return {"key_data": list(self._key), "count": self._count}

    def load_state_dict(self, d: dict) -> None:
        self._key = tuple(int(w) & _M32 for w in d["key_data"])
        self._count = int(d["count"])

    @staticmethod
    def fold(k: tuple[int, int], step: int) -> tuple[int, int]:
        return fold_in(k, step)
