"""u32-limb-pair exact colorspace for the headline quality band.

Re-expresses the bit-exact fixed-point colorspace replay
(ops.colorspace_device, proven over all 2^24 inputs) in *uint32 limb
pairs* so the whole chain runs on native 32-bit lanes — no x64
tracing and no 64-bit integer arithmetic.  Covers the two headline
paths:

- encode q >= NORM: the no-gain float matrix of ``downsample_YUV420``
  (encoder/colorspace.c:55-260) — the double-rounded Y chain and the
  float32-narrowed chroma rows;
- decode q >= NORM ("mode 0"): the plain float YUV->RGB matrix of
  ``write_image_bmp`` (decoder/nhw_decoder_cli.c:133-283).

Algebraic collapses used here (each proven exhaustively over all 2^24
input triples — tools/colorspace_limb_exhaustive.py, 0 mismatches;
partial collapses beyond these were measured to change outputs:
13,194 / 9,851 / 9,014 mismatching triples for the one-rounding forms,
so every intermediate RNE stays):

- the final ``RNE53(s + 0.5)`` before the trunc-shift folds into the
  shift itself (the rounded value's integer part equals the unrounded
  one's on the whole domain);
- every RNE53 in both directions rounds at a shift <= 11 bits (values
  are < 2^64 at scale 2^56 / signed < 2^63 at 2^54 with 53-bit
  mantissas), so the round never crosses the 32-bit limb boundary:
  one clz on the high limb + low-limb mask arithmetic;
- only the chroma RNE24s (float32 narrowing, shifts up to 40) need the
  general cross-limb round, implemented with clamped-shift selects.

Value representation: unsigned pairs ``(hi, lo)`` of uint32 (value =
hi * 2^32 + lo) at scale 2^56 (encode) / 2^54 (decode), signed values
as (sign-mask, magnitude-pair).  All helpers are ``xp``-generic: the
numpy replay is the exhaustive-proof harness, the jnp trace is the
device program.
"""

from __future__ import annotations

import numpy as np

from nhwcodec_tpu.ops.colorspace_device import (
    _HI_N, _HI_P, _MD_1402, _MD_1772, _MD_34414, _MD_71414, _MI_U, _MI_V,
    _MI_Y,
)

_HALF54 = 1 << 53


def _u32(x, xp):
    return x.astype(xp.uint32)


def _bl32(h, xp):
    """Bit length of a uint32 array (0 -> 0)."""
    if xp is np:
        return np.frexp(h.astype(np.float64))[1].astype(np.int32)
    import jax.lax as lax
    return (32 - lax.clz(h.astype(xp.int32))).astype(xp.int32)


def _const_pair(v: int):
    return np.uint32(v >> 32), np.uint32(v & 0xFFFFFFFF)


def _mulc(M: int, x, xp):
    """(hi, lo) = M * x for a compile-time constant M < 2^56 and a
    uint32 array x < 2^9.  16-bit limb products keep everything in
    native u32 lanes."""
    m0 = np.uint32(M & 0xFFFF)
    m1 = np.uint32((M >> 16) & 0xFFFF)
    m2 = np.uint32((M >> 32) & 0xFFFF)
    m3 = np.uint32(M >> 48)
    l0 = m0 * x
    l1 = m1 * x
    l2 = m2 * x
    l3 = m3 * x
    mid = (l0 >> xp.uint32(16)) + l1          # < 2^25
    lo = (l0 & xp.uint32(0xFFFF)) | ((mid & xp.uint32(0xFFFF))
                                     << xp.uint32(16))
    hi = (mid >> xp.uint32(16)) + l2 + (l3 << xp.uint32(16))
    return hi, lo


def _add_pair(h1, l1, h2, l2, xp):
    lo = l1 + l2
    carry = (lo < l1).astype(xp.uint32)
    return h1 + h2 + carry, lo


def _sub_pair(h1, l1, h2, l2, xp):
    """(h1,l1) - (h2,l2), caller guarantees the result >= 0."""
    lo = l1 - l2
    borrow = (l1 < l2).astype(xp.uint32)
    return h1 - h2 - borrow, lo


def _ge_pair(h1, l1, h2, l2):
    return (h1 > h2) | ((h1 == h2) & (l1 >= l2))


def _rne53(hi, lo, xp):
    """RNE to a 53-bit mantissa of a pair value < 2^64.  The shift is
    max(bitlen - 53, 0) <= 11, entirely inside the low limb.

    All shift amounts are clamped in int32 and cast to uint32 only at
    the shift itself."""
    one = xp.uint32(1)
    sh = xp.maximum(_bl32(hi, xp) - 21, 0).astype(xp.uint32)
    mask = (one << sh) - one
    rem = lo & mask
    half = mask ^ (mask >> one)               # 1 << (sh-1), 0 when sh == 0
    odd = (lo >> sh) & one
    up = ((rem > half) | ((rem == half) & (half != 0) & (odd == one)))
    lo_k = (lo & ~mask) + (up.astype(xp.uint32) << sh)
    carry = ((lo_k < (lo & ~mask)) & up).astype(xp.uint32)
    return hi + carry, lo_k


def _shr_pair(hi, lo, sh, xp):
    """Logical right shift of a pair by int32 sh in [0, 63] (per-lane);
    clamps stay in int32."""
    shc = xp.minimum(sh, 31).astype(xp.uint32)
    sh2 = xp.minimum(xp.maximum(sh - 32, 0), 31).astype(xp.uint32)
    lo_small = (lo >> shc) | xp.where(
        sh == 0, xp.uint32(0),
        hi << ((xp.uint32(32) - shc) & xp.uint32(31)))
    lo_small = xp.where(sh == 0, lo, lo_small)
    big = sh >= 32
    r_lo = xp.where(big, hi >> sh2, lo_small)
    r_hi = xp.where(big, xp.uint32(0), hi >> shc)
    return r_hi, r_lo


def _shl_pair(hi, lo, sh, xp):
    """Left shift of a pair by int32 sh in [0, 63] (per-lane); overflow
    out of bit 63 is the caller's responsibility to exclude."""
    shc = xp.minimum(sh, 31).astype(xp.uint32)
    sh2 = xp.minimum(xp.maximum(sh - 32, 0), 31).astype(xp.uint32)
    hi_small = (hi << shc) | xp.where(
        sh == 0, xp.uint32(0),
        lo >> ((xp.uint32(32) - shc) & xp.uint32(31)))
    hi_small = xp.where(sh == 0, hi, hi_small)
    big = sh >= 32
    r_hi = xp.where(big, lo << sh2, hi_small)
    r_lo = xp.where(big, xp.uint32(0), lo << shc)
    return r_hi, r_lo


def _rne24_pair(hi, lo, xp):
    """RNE to a 24-bit mantissa of a pair value < 2^64 (the float32
    narrowing steps); shift up to 40 crosses the limb boundary.

    Pure mask arithmetic at the original scale — no shift-down /
    shift-up / subtract reconstruction: the remainder is the masked low
    bits, the round adds ``up << sh``, and the kept bits never move.
    ~3.5x fewer VPU ops than the pair-shift form (exhaustively
    re-proven over all 2^24 triples, tools/colorspace_limb_exhaustive)."""
    one = xp.uint32(1)
    bl = xp.where(hi > 0, _bl32(hi, xp) + 32, _bl32(lo, xp))
    sh = xp.maximum(bl - 24, 0)               # int32, 0..40
    big = sh >= 32
    shc = xp.minimum(sh, 31).astype(xp.uint32)
    sh2 = xp.minimum(xp.maximum(sh - 32, 0), 31).astype(xp.uint32)
    mlo = xp.where(big, xp.uint32(0xFFFFFFFF), (one << shc) - one)
    mhi = xp.where(big, (one << sh2) - one, xp.uint32(0))
    rem_hi = hi & mhi
    rem_lo = lo & mlo
    # half = 1 << (sh - 1) as a pair (zero when sh == 0)
    h_lo = xp.where((sh >= 1) & (sh <= 32),
                    one << (xp.maximum(sh - 1, 0).astype(xp.uint32)
                            & xp.uint32(31)),
                    xp.uint32(0))
    h_hi = xp.where(sh >= 33,
                    one << xp.minimum(sh - 33, 31).astype(xp.uint32),
                    xp.uint32(0))
    odd = xp.where(big, (hi >> sh2) & one, (lo >> shc) & one)
    gt = (rem_hi > h_hi) | ((rem_hi == h_hi) & (rem_lo > h_lo))
    tie = (rem_hi == h_hi) & (rem_lo == h_lo) & (sh > 0)
    up = (gt | (tie & (odd == one))).astype(xp.uint32)
    base_lo = lo & ~mlo
    base_hi = hi & ~mhi
    a_lo = xp.where(big, xp.uint32(0), up << shc)
    a_hi = xp.where(big, up << sh2, xp.uint32(0))
    r_lo = base_lo + a_lo
    carry = (r_lo < base_lo).astype(xp.uint32)
    return base_hi + a_hi + carry, r_lo


# ---------------------------------------------------------------------------
# encode direction: the q >= NORM float matrix

_HIP_P = _const_pair(_HI_P)
_HIN_P = _const_pair(_HI_N)


def _y_norm(r, g, b, xp):
    """trunc(fl64 chain + 0.5) for 0.299/0.587/0.114 (final RNE
    collapsed into the shift)."""
    p1 = _rne53(*_mulc(_MI_Y[0], r, xp), xp)
    p2 = _rne53(*_mulc(_MI_Y[1], g, xp), xp)
    p3 = _rne53(*_mulc(_MI_Y[2], b, xp), xp)
    s = _rne53(*_add_pair(*_rne53(*_add_pair(*p1, *p2, xp), xp),
                          *p3, xp), xp)
    hi, _ = _add_pair(*s, xp.uint32(1 << 23), xp.uint32(0), xp)
    return (hi >> xp.uint32(24)).astype(xp.int32)


def _chroma_norm(r, g, b, M, sgn, xp):
    """(int)(fl32(fl64 chain) + 128.5f/128.4f) for a chroma row: exact
    signed sum, RNE24 narrow, the f32 +128.5/+128.4 add, RNE24, trunc."""
    pos_h = xp.uint32(0)
    pos_l = xp.uint32(0)
    neg_h = xp.uint32(0)
    neg_l = xp.uint32(0)
    for Mi, si, x in zip(M, sgn, (r, g, b)):
        h, lo = _mulc(Mi, x, xp)
        if si > 0:
            pos_h, pos_l = _add_pair(pos_h, pos_l, h, lo, xp)
        else:
            neg_h, neg_l = _add_pair(neg_h, neg_l, h, lo, xp)
    neg = ~_ge_pair(pos_h, pos_l, neg_h, neg_l)
    m_hi = xp.where(neg, neg_h, pos_h)
    m_lo = xp.where(neg, neg_l, pos_l)
    s_hi = xp.where(neg, pos_h, neg_h)
    s_lo = xp.where(neg, pos_l, neg_l)
    t_hi, t_lo = _sub_pair(m_hi, m_lo, s_hi, s_lo, xp)
    c_hi, c_lo = _rne24_pair(t_hi, t_lo, xp)
    w_hi = xp.where(neg, _HIN_P[0] - c_hi -
                    (_HIN_P[1] < c_lo).astype(xp.uint32),
                    _HIP_P[0] + c_hi)
    w_lo = xp.where(neg, _HIN_P[1] - c_lo, _HIP_P[1] + c_lo)
    carry = (~neg) & (w_lo < c_lo)
    w_hi = w_hi + carry.astype(xp.uint32)
    # C32 == +127.5 makes the sum exactly 2^64 (wraps): result is 256,
    # which the caller's u8 clip turns into 255 as the reference does
    ovf = (~neg) & (w_hi < _HIP_P[0])
    o_hi, _ = _rne24_pair(w_hi, w_lo, xp)
    out = (o_hi >> xp.uint32(24)).astype(xp.int32)
    return xp.where(ovf, xp.int32(256), out)


def yuv_norm_limb(r, g, b, xp):
    """q >= NORM RGB->YUV matrix rows (pre-clip ints): r, g, b uint8 /
    int arrays -> (y, u, v) int32 (u, v may be 256 on the wrap case)."""
    r = _u32(r, xp)
    g = _u32(g, xp)
    b = _u32(b, xp)
    y = _y_norm(r, g, b, xp)
    u = _chroma_norm(r, g, b, _MI_U, (-1, -1, 1), xp)
    v = _chroma_norm(r, g, b, _MI_V, (1, -1, -1), xp)
    return y, u, v


# ---------------------------------------------------------------------------
# decode direction: mode 0 (q >= NORM) YUV -> RGB

def _rne53_s(sgn, hi, lo, xp):
    h, lo = _rne53(hi, lo, xp)
    return sgn, h, lo


def _add_s(s1, h1, l1, s2, h2, l2, xp):
    """Signed (sign, pair) add in sign-magnitude form."""
    same = s1 == s2
    a_ge_b = _ge_pair(h1, l1, h2, l2)
    sum_h, sum_l = _add_pair(h1, l1, h2, l2, xp)
    d1_h, d1_l = _sub_pair(xp.where(a_ge_b, h1, h2),
                           xp.where(a_ge_b, l1, l2),
                           xp.where(a_ge_b, h2, h1),
                           xp.where(a_ge_b, l2, l1), xp)
    out_s = xp.where(same, s1, xp.where(a_ge_b, s1, s2))
    out_h = xp.where(same, sum_h, d1_h)
    out_l = xp.where(same, sum_l, d1_l)
    zero = (out_h == 0) & (out_l == 0)
    return out_s & ~zero, out_h, out_l


def _mulc_s(M: int, f, xp):
    """Signed product of constant M > 0 with a small signed int array
    f (|f| <= 128): (sign, hi, lo)."""
    sgn = f < 0
    mag = _u32(xp.where(sgn, -f, f), xp)
    h, lo = _mulc(M, mag, xp)
    return sgn, h, lo


def _chan_out(s, h, lo, xp):
    """trunc(value + 0.5) at scale 2^54 with the C toward-zero cast
    (final RNE collapsed into the shift)."""
    s, h, lo = _add_s(s, h, lo, xp.zeros_like(s), xp.uint32(1 << 21),
                      xp.uint32(0), xp)
    mag = (h >> xp.uint32(22)).astype(xp.int32)
    return xp.where(s, -mag, mag)


def rgb_mode0_limb(y, u, v, xp):
    """Mode-0 (q >= NORM) YUV->RGB rows (pre-clip int32 r, g, b)."""
    yu = _u32(y, xp)
    uf = u.astype(xp.int32) - 128
    vf = v.astype(xp.int32) - 128
    y_s = xp.zeros(yu.shape, dtype=bool)
    y_h = yu << xp.uint32(22)
    y_l = xp.zeros_like(yu)

    tr = _rne53_s(*_mulc_s(_MD_1402, vf, xp), xp)
    ir = _rne53_s(*_add_s(y_s, y_h, y_l, *tr, xp), xp)
    r = _chan_out(*ir, xp)

    ta = _rne53_s(*_mulc_s(_MD_34414, uf, xp), xp)
    ta = (~ta[0] & ((ta[1] != 0) | (ta[2] != 0)), ta[1], ta[2])
    tb = _rne53_s(*_mulc_s(_MD_71414, vf, xp), xp)
    tb = (~tb[0] & ((tb[1] != 0) | (tb[2] != 0)), tb[1], tb[2])
    ig = _rne53_s(*_add_s(*_rne53_s(*_add_s(y_s, y_h, y_l, *ta, xp), xp),
                          *tb, xp), xp)
    g = _chan_out(*ig, xp)

    tc = _rne53_s(*_mulc_s(_MD_1772, uf, xp), xp)
    ib = _rne53_s(*_add_s(y_s, y_h, y_l, *tc, xp), xp)
    b = _chan_out(*ib, xp)
    return r, g, b
