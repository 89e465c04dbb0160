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

`SeedStream` (named and sequential subkeys for layer init and dropout)
is not ported yet: the port's init draws from `torch.Generator`s.
"""

from __future__ import annotations

import math

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


def random_bits(k: tuple[int, int], shape, device=None) -> torch.Tensor:
    """32 random bits for each element of ``shape``, as an int64 tensor
    of values in [0, 2^32)."""
    i = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    return bits_at(k, i).reshape(shape)


def _uniform(bits: torch.Tensor, minval: float, maxval: float) -> torch.Tensor:
    one = (bits >> 9) | 0x3F800000
    floats = one.to(torch.int32).view(torch.float32) - 1.0
    lo, hi = (torch.tensor(x, dtype=torch.float32) for x in (minval, maxval))
    return torch.clamp_min(floats * (hi - lo).item() + lo.item(), lo.item())


def uniform(k: tuple[int, int], shape, minval: float = 0.0, maxval: float = 1.0,
            device=None) -> torch.Tensor:
    """f32 uniform on [minval, maxval): the top 23 bits as the mantissa of
    a float in [1, 2), minus 1, scaled, and held at minval or above."""
    return _uniform(random_bits(k, shape, device), minval, maxval)


def _f32(v: float) -> float:
    return torch.tensor(v, dtype=torch.float32).item()


# Cephes' log polynomial, as Eigen's `plog` and XLA's CPU backend evaluate it
_SQRTHF = _f32(0.707106781186547524)
_LOG_P = [_f32(v) for v in (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
                            -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
                            2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)]
_LOG_Q1, _LOG_Q2 = _f32(-2.12194440e-4), _f32(0.693359375)


def _fma(a, b, c):
    """f32 a * b + c as a fused multiply-add gives it: the product is
    exact in f64, the sum is rounded to f64 and then to f32.  Those two
    roundings differ from a single f32 one only where the f64 sum lands
    on an f32 tie; none of the values the tests compare with jax does."""
    a, b = (x.double() if isinstance(x, torch.Tensor) else x for x in (a, b))
    return (a * b + c).float()


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
