"""Exact IEEE-754 float emulation over integer lanes (device softfloat).

The reference's colorspace stages compute in C ``double``/``float`` with
result-critical roundings (encoder/colorspace.c:55-260 rounding constants,
decoder/nhw_decoder_cli.c:133-291 inverse matrices).  Device f64 is slow
or absent, and native f32 is vulnerable to FMA contraction differences
across backends — so the bit-exact device path emulates the exact IEEE
arithmetic with pure int64 element-wise ops (platform-independent: the
same bits on every JAX backend and the numpy host path).

A float is an (s, m, e) triple of integer arrays:
  value = (-1)^s * m * 2^(e - (P-1)),   m == 0 or 2^(P-1) <= m < 2^P
with P = 53 (binary64) or P = 24 (binary32).  No inf/nan/subnormals: the
codec's value domain is bounded (|v| < 2^10) and normal.

All rounding is round-to-nearest-even, matching IEEE default mode (the
reference never changes the x87/SSE rounding mode).

Every function takes ``xp`` (numpy or jax.numpy); under jax the int64
lanes require x64 tracing — wrap calls in ``jax.enable_x64(True)``
(see ops.colorspace_device).
"""

from __future__ import annotations

import numpy as np

_ZERO_E = -10000  # exponent tag for zero (far below any live exponent)


def pack_f64(values) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-side: numpy float64 array -> exact (s, m, e) int64 triples."""
    v = np.asarray(values, np.float64)
    s = (np.signbit(v)).astype(np.int64)
    mf, ef = np.frexp(np.abs(v))  # |v| = mf * 2^ef, mf in [0.5, 1)
    m = np.round(mf * (1 << 53)).astype(np.int64)
    e = (ef - 1).astype(np.int64)
    zero = v == 0
    return (np.where(zero, 0, s), np.where(zero, 0, m),
            np.where(zero, _ZERO_E, e))


def pack_const(value: float) -> tuple[int, int, int]:
    """One python float -> (s, m, e) ints for splicing into traced code."""
    s, m, e = pack_f64(np.float64(value))
    return int(s), int(m), int(e)


def _bitlen(m, xp):
    """Bit length of a non-negative int64 array (0 -> 0).  float32 gives
    the exponent estimate; the two compares fix conversion rounding."""
    f = m.astype(xp.float32)
    est = xp.frexp(f)[1].astype(xp.int64)
    est = xp.maximum(est, xp.int64(1))
    # m < 2^(est-1)  <=>  m >> (est-1) == 0  (exact for est-1 <= 63,
    # unlike 1 << est which overflows past 2^62)
    est = xp.where((m >> xp.minimum(est - 1, xp.int64(63))) == 0,
                   est - 1, est)
    est = xp.where((m >> xp.minimum(est, xp.int64(63))) != 0,
                   est + 1, est)
    return xp.where(m == 0, xp.int64(0), est)


def _norm(s, m, e, P, xp):
    """Renormalize (value = m * 2^(e-(P-1)), m any width up to ~2^60)
    to a P-bit mantissa with RNE.  m's low bit may carry a sticky OR."""
    one = xp.int64(1)
    L = _bitlen(m, xp)
    shift = L - P
    shr = xp.maximum(shift, xp.int64(0))
    keep = m >> shr
    rem = m & ((one << shr) - 1)
    half = xp.where(shr > 0, one << xp.maximum(shr - 1, 0), xp.int64(0))
    up = (rem > half) | ((rem == half) & ((keep & 1) == 1))
    keep = keep + xp.where((shift > 0) & up, one, xp.int64(0))
    # carry out of the rounding (keep == 2^P): exact power, shift back
    ovf = keep == (one << P)
    keep = xp.where(ovf, keep >> 1, keep)
    shift = shift + ovf.astype(xp.int64)
    # left-normalize small results (cancellation in subtract)
    shl = xp.maximum(-shift, xp.int64(0))
    keep = xp.where(shift < 0, m << xp.minimum(shl, 62), keep)
    e = e + shift
    zero = keep == 0
    return (xp.where(zero, 0, s), keep, xp.where(zero, _ZERO_E, e))


def add(a, b, P, xp):
    """IEEE RNE addition of two (s, m, e) triples of precision P."""
    sa, ma, ea = a
    sb, mb, eb = b
    one = xp.int64(1)
    a_big = (ea > eb) | ((ea == eb) & (ma >= mb))
    sB = xp.where(a_big, sa, sb)
    mB = xp.where(a_big, ma, mb)
    eB = xp.where(a_big, ea, eb)
    sS = xp.where(a_big, sb, sa)
    mS = xp.where(a_big, mb, ma)
    eS = xp.where(a_big, eb, ea)

    d = xp.clip(eB - eS, 0, 62)
    mB3 = mB << 3
    mS3 = mS << 3
    sticky = (mS3 & ((one << d) - 1)) != 0
    mSa = (mS3 >> d) | sticky.astype(xp.int64)

    diff_sign = (sB != sS) & (mS != 0)
    m = xp.where(diff_sign, mB3 - mSa, mB3 + mSa)
    # equal-magnitude cancellation -> +0 (IEEE RNE: x + (-x) = +0)
    return _norm(xp.where(m == 0, 0, sB), m, eB - 3, P, xp)


def mul_const(a, c: tuple[int, int, int], P, xp):
    """Multiply (s, m, e) by a compile-time constant (sc, mc, ec) with
    exact 106-bit product accumulation in 27-bit limbs, RNE to P bits."""
    sa, ma, ea = a
    sc, mc, ec = c
    one = xp.int64(1)
    mask27 = (1 << 27) - 1
    a0 = ma & mask27
    a1 = ma >> 27
    c0 = mc & mask27
    c1 = mc >> 27
    lo_raw = a0 * c0
    mid = a1 * c0 + a0 * c1
    hi_raw = a1 * c1
    lo = lo_raw + ((mid & mask27) << 27)          # < 2^55
    hi = hi_raw + (mid >> 27)                     # < 2^53
    hi = hi + (lo >> 54)
    lo = lo & ((one << 54) - 1)
    # product = hi * 2^54 + lo, bitlen 105 or 106 (for normal inputs)
    L = _bitlen(hi, xp) + 54
    shift = L - P                                 # 52 or 53 at P=53
    sh_lo = xp.minimum(shift, xp.int64(54))
    keep = (hi << (54 - sh_lo)) | (lo >> sh_lo)
    rem = lo & ((one << sh_lo) - 1)
    half = one << xp.maximum(sh_lo - 1, 0)
    up = (rem > half) | ((rem == half) & ((keep & 1) == 1))
    keep = keep + up.astype(xp.int64)
    ovf = keep == (one << P)
    keep = xp.where(ovf, keep >> 1, keep)
    shift = shift + ovf.astype(xp.int64)
    # value = product * 2^(ea-52+ec-52); keep = product >> shift
    # => value = keep * 2^(ea+ec-104+shift) = keep * 2^(e-(P-1))
    e = ea + ec - 104 + shift + (P - 1)
    s = sa ^ sc
    zero = (ma == 0)
    return (xp.where(zero, 0, s), xp.where(zero, 0, keep),
            xp.where(zero, _ZERO_E, e))


def narrow_to_f32(a, xp):
    """binary64 (P=53) -> binary32 (P=24) with RNE.

    _norm's input scale is tied to the target precision
    (value = m * 2^(e_in - (P-1))), so the P=53 exponent shifts by
    53 - 24 = 29 to keep the represented value fixed."""
    s, m, e = a
    e = xp.where(m == 0, e, e - 29)
    return _norm(s, m, e, 24, xp)


def trunc_to_int(a, P, xp):
    """C cast (int)x: truncation toward zero.  |value| < 2^31 assumed."""
    s, m, e = a
    one = xp.int64(1)
    t = e - (P - 1)
    mag = xp.where(
        t >= 0,
        m << xp.clip(t, 0, 62),
        m >> xp.clip(-t, 0, 62),
    )
    mag = xp.where(e < 0, xp.int64(0), mag)
    return xp.where(s == 1, -mag, mag).astype(xp.int64)


def is_nonneg(a, xp):
    """value >= 0 (zero is always +0 in this representation)."""
    s, m, e = a
    return (s == 0) | (m == 0)


def lut_gather(lut: tuple[np.ndarray, np.ndarray, np.ndarray], idx, xp):
    """Gather an (s, m, e) 256-entry product LUT at integer indices."""
    s, m, e = (xp.asarray(t.astype(np.int64)) for t in lut)
    i = idx.astype(xp.int32)
    return s[i], m[i], e[i]


def mul_small_int(c: tuple[int, int, int], x, xp):
    """fl64(constant * x) for a non-negative integer array x < 2^10.

    The exact product m_c * x fits int64 (<= 63 bits), so one multiply +
    one RNE renormalize reproduces the double product — no per-pixel
    gathers."""
    sc, mc, ec = c
    m = xp.int64(mc) * x.astype(xp.int64)
    s = xp.full(m.shape, sc, dtype=xp.int64)
    e = xp.full(m.shape, ec, dtype=xp.int64)
    return _norm(s, m, e, 53, xp)
