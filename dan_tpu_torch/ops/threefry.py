"""A numpy copy of `jax.random`'s default generator, threefry2x32, for the
scalar draws of the train-time augmentation and the arrays of the JAX
package's parameter init: `prng_key`, `split`, `random_bits`, `uniform`,
`bernoulli`, `randint` and `normal` give the bits and the values that
`jax.random.PRNGKey`, `split`, `bits`, `uniform`, `bernoulli`, `randint`
and `normal` give for the same key, so that a port train run draws the JAX
package's augmentation numbers from the same per-image seeds, and a
partial checkpoint's uncovered leaves get the JAX package's init
(models/reference_init.py).

It follows JAX's defaults as of jax 0.9.0: `jax_threefry_partitionable =
True` (a split and the random bits hash the 64-bit iota of the output
shape as two 32-bit counter words, high word first), legacy uint32 keys
of shape (2,), float32 values.  A key is a pair of uint32 arrays of one
shape: a scalar key, or one key for each image of a batch, so that a
batch's draws take one hash a draw.  Every function maps over the key's
shape; a scalar key gives a numpy scalar.  XLA compiles uniform's
`u * (maxval - minval) + minval` into one fused multiply-add on the CPU,
so `uniform` rounds that product-sum once (`_fma_f32`); a separate
multiply and add differ in the last bit for about half of all draws.

An array draw (`shape` given) takes a scalar key and hashes the 64-bit
row-major index of each element as the counter (high word, low word).
`normal` is sqrt(2) * erf_inv of a uniform on (nextafter(-1, 0), 1), with
XLA's float32 erf_inv (Giles' polynomials, its multiply-adds fused as XLA
fuses them on the CPU); numpy's log1p and XLA's differ in the last bit, so
about 1.3 % of the normals differ from JAX's by 1 to 3 ulp (the bits and
the uniforms are exact).

    key = prng_key(seed)                     # jax.random.PRNGKey(seed)
    k_color, k_flip = split(key)             # jax.random.split(key)
    u = uniform(k, -0.1, 0.1)                # jax.random.uniform(k, (), minval=, maxval=)
    on = bernoulli(k, 0.5)                   # jax.random.bernoulli(k, 0.5)
    i = randint(k, 0, 4)                     # jax.random.randint(k, (), 0, 4)
    w = normal(k, (3, 3, 64, 128))           # jax.random.normal(k, (3, 3, 64, 128))
    keys = prng_key(np.array([3, 4, 5]))     # jax.vmap(jax.random.PRNGKey)(seeds)
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

Key = Tuple[np.ndarray, np.ndarray]

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def _scalar(x):
    """A 0-d array as a numpy scalar; any other array as it is."""
    return np.asarray(x)[()]


def threefry2x32(key: Key, x0, x1) -> Tuple[np.ndarray, np.ndarray]:
    """The threefry-2x32 hash of the counter words (x0, x1) (uint32 arrays
    that broadcast against the key's words) under `key`, 20 rounds, as
    jax._src.prng's lowering."""
    k0, k1 = np.asarray(key[0], np.uint32), np.asarray(key[1], np.uint32)
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    with np.errstate(over="ignore"):
        x = [np.asarray(x0, np.uint32) + ks[0], np.asarray(x1, np.uint32) + ks[1]]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def prng_key(seed) -> Key:
    """jax.random.PRNGKey(seed) for a seed (or an array of seeds) in
    [0, 2**32): (0, seed)."""
    seed = np.asarray(seed, np.int64)
    if seed.size and not (0 <= seed.min() and seed.max() < 2**32):
        raise ValueError(f"seed must be in [0, 2**32), got {seed.min()}..{seed.max()}")
    seed = seed.astype(np.uint32)
    return (_scalar(np.zeros_like(seed)), _scalar(seed))


def split(key: Key, num: int = 2) -> List[Key]:
    """jax.random.split(key, num): the hash of the counters (0, i)."""
    i = np.arange(num, dtype=np.uint32).reshape((num,) + (1,) * np.ndim(key[0]))
    hi, lo = threefry2x32(key, np.zeros_like(i), i)
    return [(_scalar(hi[j]), _scalar(lo[j])) for j in range(num)]


def random_bits(key: Key, shape: Tuple[int, ...] = ()) -> np.ndarray:
    """jax.random.bits(key, shape): for each element the two words of the
    hash of its row-major index (high word, low word), xor'd; a scalar
    shape hashes (0, 0) for every key of an array of keys."""
    if shape == ():
        hi, lo = threefry2x32(key, np.zeros((), np.uint32), np.zeros((), np.uint32))
        return _scalar(hi ^ lo)
    if np.ndim(key[0]):
        raise ValueError("an array draw takes a scalar key")
    i = np.arange(int(np.prod(shape, dtype=np.int64)), dtype=np.uint64)
    hi, lo = threefry2x32(key, (i >> np.uint64(32)).astype(np.uint32), i.astype(np.uint32))
    return (hi ^ lo).reshape(shape)


def _fma_f32(a, b, c) -> np.ndarray:
    """a * b + c for float32 arrays, rounded once to the nearest float32
    (ties to even).  The product is exact in float64 and TwoSum gives the
    sum's float64 rounding s and its error e exactly.  Rounding s to
    float32 rounds the exact sum the same way unless s lies halfway
    between two float32 values: there the sign of e decides."""
    a, b, c = (np.asarray(v, np.float32).astype(np.float64) for v in (a, b, c))
    p = a * b
    s = p + c
    bv = s - p
    e = (p - (s - bv)) + (c - bv)
    r = s.astype(np.float32)
    rd = r.astype(np.float64)
    other = np.where(rd > s, np.nextafter(r, np.float32(-np.inf)),
                     np.nextafter(r, np.float32(np.inf)))
    tie = (rd != s) & ((rd + other.astype(np.float64)) * 0.5 == s) & (e != 0)
    toward = np.where(e > 0, np.maximum(r, other), np.minimum(r, other))
    return np.where(tie, toward, r)


def uniform(key: Key, minval: float = 0.0, maxval: float = 1.0,
            shape: Tuple[int, ...] = ()):
    """jax.random.uniform(key, shape, float32, minval, maxval): 23 random
    mantissa bits under the exponent of 1.0, minus 1, scaled in float32."""
    lo, hi = np.float32(minval), np.float32(maxval)
    bits = (np.asarray(random_bits(key, shape)) >> np.uint32(9)) | np.float32(1.0).view(np.uint32)
    u = bits.view(np.float32) - np.float32(1.0)
    return _scalar(np.maximum(lo, _fma_f32(u, np.float32(hi - lo), lo)))


def bernoulli(key: Key, p: float):
    """jax.random.bernoulli(key, p) for a scalar p: uniform < p in float32."""
    return _scalar(np.asarray(uniform(key)) < np.float32(p))


def randint(key: Key, minval: int, maxval: int):
    """jax.random.randint(key, (), minval, maxval) for int32: two words of
    random bits from a split, combined modulo the span as JAX does."""
    if maxval <= minval:
        return _scalar(np.full(np.shape(key[0]), minval, np.int64))
    span = np.uint32(maxval - minval)
    k1, k2 = split(key)
    higher, lower = np.asarray(random_bits(k1)), np.asarray(random_bits(k2))
    with np.errstate(over="ignore"):
        multiplier = np.uint32(2**16) % span
        multiplier = np.uint32(multiplier * multiplier) % span
        offset = ((higher % span) * multiplier + lower % span) % span
    return _scalar(np.int64(minval) + offset.astype(np.int64))


# XLA's float32 erf_inv (Giles, "Approximating the erfinv function"): a
# degree-8 polynomial in w - 2.5 where w = -log1p(-x * x) < 5, else in
# sqrt(w) - 3, times x.  Highest coefficient first.
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                 0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                 0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x) -> np.ndarray:
    """lax.erf_inv on float32 as XLA computes it on the CPU, Horner steps
    fused into one rounding each; +-1 give +-inf."""
    x = np.asarray(x, np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        w = -np.log1p(-(x * x))
        small = w < np.float32(5)
        w = np.where(small, w - np.float32(2.5), np.sqrt(w) - np.float32(3)).astype(np.float32)
        coef = [np.where(small, np.float32(a), np.float32(b))
                for a, b in zip(_ERFINV_SMALL, _ERFINV_LARGE)]
        p = coef[0]
        for c in coef[1:]:
            p = _fma_f32(p, w, c)
        return np.where(np.abs(x) == 1, x * np.float32(np.inf), p * x)


def normal(key: Key, shape: Tuple[int, ...] = ()):
    """jax.random.normal(key, shape) in float32: sqrt(2) * erf_inv(u), u
    uniform on (nextafter(-1, 0), 1).  Within 3 ulp of JAX's, and equal to
    it for about 98.7 % of the draws (see the module's docstring)."""
    lo = np.nextafter(np.float32(-1), np.float32(0))
    u = uniform(key, lo, 1.0, shape)
    return _scalar(np.float32(np.sqrt(2)) * erf_inv(u))
