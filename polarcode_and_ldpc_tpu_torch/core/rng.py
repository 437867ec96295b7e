"""Keyed, counter-based randomness: threefry2x32 in plain torch integer ops.

Every random quantity derives from an explicit key, and per-frame keys derive
from the *global frame id* (``frame_keys``), so Monte-Carlo counts do not
depend on batch size, chunking or dispatch layout.  The generator is the
threefry2x32 block cipher with the counter layout of ``jax.random`` under
``jax_threefry_partitionable=True`` (the 64-bit flat index of a shaped draw,
high word / low word), so the same key gives the same bits as the JAX
package: ``fold_in``, ``split``, raw bits and ``bernoulli`` are equal bit
for bit; ``normal`` agrees to the last bits of the float32 ``erf_inv``
polynomial (see ``erf_inv_f32``).

A key is an ``int32`` tensor ``[..., 2]`` holding the *bit patterns* of the
two ``uint32`` key words (torch has thin ``uint32`` support).  All cipher
arithmetic is two's-complement ``int32``: adds wrap, and the rotation masks
the sign-extended bits of the arithmetic right shift.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _as_i32(values, device=None) -> torch.Tensor:
    """Integers (any width, signed or unsigned) → int32 bit patterns."""
    t = torch.as_tensor(values, device=device)
    if t.dtype == torch.int32:
        return t
    return t.to(torch.int64).to(torch.int32)  # truncating cast wraps mod 2^32


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    """Rotate int32 bit patterns left by ``r`` (0 < r < 32); new tensor."""
    hi = x << r
    lo = (x >> (32 - r)).bitwise_and_((1 << r) - 1)  # logical shift
    return hi.bitwise_or_(lo)


def threefry2x32(k0, k1, x0, x1):
    """The 20-round threefry2x32 block function on int32 bit patterns.

    ``k0, k1`` are the key words and ``x0, x1`` the counter words, mutually
    broadcastable.  Returns two new tensors of the broadcast shape.
    """
    k0, k1, x0, x1 = torch.broadcast_tensors(k0, k1, x0, x1)
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = x0 + k0
    x1 = x1 + k1
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0.add_(x1)
            x1 = _rotl(x1, r).bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3])
        x1.add_(ks[(i + 2) % 3]).add_(i + 1)
    return x0, x1


def prng_key(seed: int, device="cpu") -> torch.Tensor:
    """Key of an integer seed: the seed's high and low 32-bit words."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    words = np.array([seed >> 32, seed & 0xFFFFFFFF], np.uint32)
    return torch.from_numpy(words.view(np.int32).copy()).to(device)


def key_words(key: torch.Tensor) -> np.ndarray:
    """Key(s) as ``uint32`` numpy words (for comparison and storage)."""
    return key.detach().cpu().numpy().astype(np.int32).view(np.uint32)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """Fold 32-bit integer(s) into key(s): ``key [..., 2]``, ``data [...]``
    (broadcast against the key's leading axes) → keys ``[..., 2]``."""
    d = _as_i32(data, key.device)
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack([y0, y1], dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``num`` new keys from each key: ``[..., 2]`` → ``[..., num, 2]`` (one
    key ``[2]`` gives ``[num, 2]``; per-frame keys ``[B, 2]`` give ``[B, num,
    2]``, what ``jax.random.split`` gives each frame under ``vmap``)."""
    idx = torch.arange(num, dtype=torch.int32, device=key.device)
    y0, y1 = threefry2x32(key[..., 0:1], key[..., 1:2], torch.zeros_like(idx), idx)
    return torch.stack([y0, y1], dim=-1)


split_key = split  # the JAX package's name: ``num`` keys, key *i* = ``fold_in(key, i)``


def frame_keys(root_key: torch.Tensor, global_frame_ids) -> torch.Tensor:
    """One key per frame from its global frame id: the key of frame *i* is
    the same whichever chunk or batch the frame lands in."""
    return fold_in(root_key, _as_i32(global_frame_ids, root_key.device))


def random_bits_2x32(keys: torch.Tensor, n: int):
    """Both cipher output words for a draw of ``n`` values per key:
    ``keys [..., 2]`` → two int32 tensors ``[..., n]``.  The counter of
    element *j* is (0, j) — the partitionable layout for one draw axis."""
    j = torch.arange(n, dtype=torch.int32, device=keys.device)
    return threefry2x32(keys[..., 0:1], keys[..., 1:2], torch.zeros_like(j), j)


def random_bits32(keys: torch.Tensor, n: int) -> torch.Tensor:
    """32 random bits per element (the XOR of the two output words)."""
    b0, b1 = random_bits_2x32(keys, n)
    return b0.bitwise_xor_(b1)


def bernoulli_half(keys: torch.Tensor, n: int, x64: bool = False) -> torch.Tensor:
    """Fair coin flips ``[..., n]`` int8, equal to
    ``jax.random.bernoulli(key, 0.5, (n,))``: ``uniform < 0.5`` is the
    complement of the uniform's top mantissa bit.  Under ``jax_enable_x64``
    the uniform is 64 bits wide and its top bit is the top bit of the first
    output word; otherwise it is the top bit of the two words' XOR.
    """
    b0, b1 = random_bits_2x32(keys, n)
    top = b0 if x64 else b0.bitwise_xor_(b1)
    return (top >= 0).to(torch.int8)  # sign bit clear ⇔ uniform < 0.5


def bernoulli(keys: torch.Tensor, p: float, n: int, x64: bool = False) -> torch.Tensor:
    """Bernoulli draws ``[..., n]`` bool, equal to ``jax.random.bernoulli(key,
    p, (n,))``: ``uniform < p`` in the uniform's dtype, float32 by default
    and float64 under ``jax_enable_x64`` (``x64=True``), where the two give
    other draws from the same key."""
    if x64:
        return uniform_f64(keys, n, 0.0, 1.0) < float(p)
    return uniform_f32(keys, n, 0.0, 1.0) < float(np.float32(p))


def draw(sample, key: torch.Tensor, shape) -> torch.Tensor:
    """``sample(keys, n)`` over a tensor of ``shape``: one key ``[2]`` draws
    the whole tensor as one flat stream of ``prod(shape)`` values, as a
    shaped ``jax.random`` draw does; keys ``[..., 2]`` whose leading axes are
    ``shape[:-1]`` draw ``shape[-1]`` values each (one key per frame)."""
    shape = tuple(shape)
    if key.dim() == 1:
        return sample(key, math.prod(shape)).reshape(shape)
    return sample(key, shape[-1])


def uniform_f32(keys: torch.Tensor, n: int, minval: float, maxval: float) -> torch.Tensor:
    """float32 uniforms in ``[minval, maxval)``: 23 random mantissa bits on
    the exponent of 1.0, minus 1, then scaled — all in float32."""
    bits = random_bits32(keys, n)
    mant = (bits >> 9).bitwise_and_(0x7FFFFF).bitwise_or_(0x3F800000)
    floats = mant.view(torch.float32) - 1.0
    lo = np.float32(minval)
    scale = np.float32(np.float32(maxval) - lo)
    return torch.clamp_min(floats * float(scale) + float(lo), float(lo))


def uniform_f64(keys: torch.Tensor, n: int, minval: float, maxval: float) -> torch.Tensor:
    """float64 uniforms from 64 random bits (52 mantissa bits)."""
    b0, b1 = random_bits_2x32(keys, n)
    word = (b0.to(torch.int64) << 32) | (b1.to(torch.int64) & 0xFFFFFFFF)
    mant = ((word >> 12) & ((1 << 52) - 1)) | 0x3FF0000000000000
    floats = mant.view(torch.float64) - 1.0
    return torch.clamp_min(floats * (maxval - minval) + minval, minval)


_ERFINV_CENTRAL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                   -4.39150654e-06, 0.00021858087, -0.00125372503,
                   -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_TAIL = (-0.000200214257, 0.000100950558, 0.00134934322,
                -0.00367342844, 0.00573950773, -0.0076224613,
                0.00943887047, 1.00167406, 2.83297682)


def erf_inv_f32(x: torch.Tensor) -> torch.Tensor:
    """Giles' single-precision ``erf_inv`` polynomial, as XLA evaluates it
    for float32: ``w = -log1p(-x²)``, one degree-8 polynomial for ``w < 5``
    and one in ``sqrt(w)`` beyond, times ``x``.  ``torch.erfinv`` is a
    different approximation and differs in the last bits."""
    w = -torch.log1p(-(x * x))
    central = w < 5.0
    w = torch.where(central, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(central, _ERFINV_CENTRAL[0], _ERFINV_TAIL[0]).to(x.dtype)
    for c_lo, c_hi in zip(_ERFINV_CENTRAL[1:], _ERFINV_TAIL[1:]):
        p = torch.where(central, c_lo, c_hi).to(x.dtype) + p * w
    out = p * x
    return torch.where(x.abs() == 1.0, x * math.inf, out)


def normal(keys: torch.Tensor, n: int, dtype=torch.float32) -> torch.Tensor:
    """Standard normals ``[..., n]``: uniform on (−1, 1) through ``erf_inv``
    times √2, as ``jax.random.normal`` draws them."""
    if dtype == torch.float32:
        lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
        u = uniform_f32(keys, n, lo, 1.0)
        return erf_inv_f32(u) * float(np.float32(math.sqrt(2.0)))
    if dtype == torch.float64:
        lo = float(np.nextafter(-1.0, 0.0))
        u = uniform_f64(keys, n, lo, 1.0)
        return torch.erfinv(u) * math.sqrt(2.0)
    raise TypeError(f"normal: unsupported dtype {dtype}")
