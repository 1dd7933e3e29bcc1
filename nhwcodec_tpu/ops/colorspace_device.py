"""Bit-exact device colorspace: RGB -> YUV 4:2:0, all 23 qualities.

Replicates encoder/colorspace.c:55-260 (downsample_YUV420) exactly on
device: the double-precision sums, the float32 chroma intermediate, the
sign-dependent +128.5f/+128.4f rounding, the LOW1-LOW3 gains and the
integer Qtz path.  The float semantics run as an exact fixed-point
replay over uint64 lanes (identical bits on every JAX backend and the
numpy host oracle); ops.softfloat documents and tests the underlying generic
IEEE emulation the replay was derived from and proven against.

Public entry: ``rgb_to_yuv420_device_exact(rgb, quality)`` — jitted per
quality, x64-traced.  Verified against the (oracle-dump-verified) host
path over all 2^24 RGB triples (tools/colorspace_exhaustive.py;
structured slices in tests/test_colorspace_device.py).
"""

from __future__ import annotations

import functools

import numpy as np

try:
    import jax
except Exception:  # noqa: BLE001 — host-only use
    jax = None

from nhwcodec_tpu import tables as T
from nhwcodec_tpu.ops.colorspace import QTZ


# ---------------------------------------------------------------------------
# exact fixed-point fast path for the no-gain float matrix (q >= NORM)
#
# Every double in that chain — the products fl64(c*x) for x in 0..255,
# their left-to-right partial sums, and the +0.5 add — has exponent
# >= -4, so each is an exact multiple of 2^-56 and below 2^8: the whole
# Y chain replays losslessly in uint64 at scale 2^56 with an
# RNE-to-53-bits step after each operation.  For chroma, collapsing the
# three binary64 roundings + the float32 narrowing into a single
# RNE-to-24-bits of the exact scaled sum is proven bit-identical to the
# softfloat chain exhaustively over all 2^24 RGB triples
# (tools/colorspace_exhaustive.py, which sweeps this path); the
# subsequent +128.5f/+128.4f float32 add and (int) trunc are exact
# scaled-integer steps (one more RNE24 — a true IEEE single rounding,
# no collapse).
# This replaces ~25 softfloat add/mul/norm calls per pixel with 5+4+4
# renormalize steps, all uint64 VPU lanes.

_MI_Y = tuple(int(np.float64(c) * (1 << 56)) for c in (0.299, 0.587, 0.114))
_MI_U = tuple(int(np.float64(c) * (1 << 56)) for c in (0.1687, 0.3313, 0.5))
_MI_V = tuple(int(np.float64(c) * (1 << 56)) for c in (0.5, 0.4187, 0.0813))
_HI_P = int(np.float64(128.5) * (1 << 56))              # exact, < 2^64
_HI_N = int(np.float64(np.float32(128.4)) * (1 << 56))  # exact (f32 const)


def _bitlen_u64(x, xp):
    """Bit length of a uint64 array (0 -> 0); float32 estimate + two
    fixups (same scheme as softfloat._bitlen, guarded so the occurring
    domain's top value 2^64 - k*2^39, k >= 1, never misclassifies)."""
    f = x.astype(xp.float32)
    est = xp.frexp(f)[1].astype(xp.int64)
    est = xp.maximum(est, xp.int64(1))
    est = xp.where(
        (x >> xp.minimum(est - 1, 63).astype(xp.uint64)) == 0, est - 1, est)
    est = xp.where(
        (est < 64) & ((x >> xp.minimum(est, 63).astype(xp.uint64)) != 0),
        est + 1, est)
    return xp.where(x == 0, xp.int64(0), est)


def _rne_u64(x, P: int, xp):
    """Round x (uint64, value x * 2^-56) to a P-bit mantissa with RNE;
    returns the rounded value at the same 2^-56 scale (exact: every
    result in the occurring domain has ulp >= 2^-56)."""
    one = xp.uint64(1)
    L = _bitlen_u64(x, xp)
    shift = xp.maximum(L - P, xp.int64(0)).astype(xp.uint64)
    keep = x >> shift
    rem = x & ((one << shift) - one)
    half = xp.where(shift > 0,
                    one << (xp.maximum(shift, one) - one), xp.uint64(0))
    up = (rem > half) | ((rem == half) & (shift > 0)
                        & ((keep & one) == one))
    return (keep + up.astype(xp.uint64)) << shift


def _y_fast(r, g, b, xp):
    """trunc(fl64 chain + 0.5) for the 0.299/0.587/0.114 row."""
    p1 = _rne_u64(xp.uint64(_MI_Y[0]) * r.astype(xp.uint64), 53, xp)
    p2 = _rne_u64(xp.uint64(_MI_Y[1]) * g.astype(xp.uint64), 53, xp)
    p3 = _rne_u64(xp.uint64(_MI_Y[2]) * b.astype(xp.uint64), 53, xp)
    s = _rne_u64(_rne_u64(p1 + p2, 53, xp) + p3, 53, xp)
    w = _rne_u64(s + xp.uint64(1 << 55), 53, xp)
    return (w >> xp.uint64(56)).astype(xp.int64)


def _chroma_fast(r, g, b, M, sgn, xp):
    """(int)(fl32(fl64 chain) + 128.5f/128.4f) for a chroma row."""
    t = (xp.int64(sgn[0] * M[0]) * r.astype(xp.int64)
         + xp.int64(sgn[1] * M[1]) * g.astype(xp.int64)
         + xp.int64(sgn[2] * M[2]) * b.astype(xp.int64))
    c32 = _rne_u64(xp.abs(t).astype(xp.uint64), 24, xp)
    neg = t < 0
    w = xp.where(neg, xp.uint64(_HI_N) - c32, c32 + xp.uint64(_HI_P))
    # C32 == +127.5 makes the sum exactly 2^64 (wraps): result is 256,
    # which the caller's u8 clip turns into 255 as the reference does
    ovf = (~neg) & (w < c32)
    out = (_rne_u64(w, 24, xp) >> xp.uint64(56)).astype(xp.int64)
    return xp.where(ovf, xp.int64(256), out)


# gain mantissas at scale 2^54 (all exact: the f32 gains promoted to
# double have 24-bit mantissas; 0.94 is a double literal with ulp 2^-54)
_MI_GAIN = {
    T.LOW1: int(np.float64(np.float32(0.975)) * (1 << 54)),
    T.LOW2: int(np.float64(np.float32(0.93)) * (1 << 54)),
    T.LOW3: int(np.float64(0.94) * (1 << 54)),
}


def _gain_mul_rne53(x, mg: int, xp):
    """fl64(gain * v) for v = x * 2^-56 (x uint64, a 53-bit-mantissa
    double in the chain) and gain = mg * 2^-54: exact 118-bit product
    via 27-bit limbs, RNE to 53 bits, returned at scale 2^-56 (exact:
    gain in (0.9, 1) keeps every product's exponent >= -4).

    The rounding position is clamped to bit 54 (d >= 0), which is
    coarser than fl64 only for |v| < 2^-4 — reachable solely through
    chroma cancellation, where any |c| < 1/16 lands on output 128 after
    the +128.5f/+128.4f add regardless of these low-order bits (and the
    exhaustive sweep covers it)."""
    one = xp.uint64(1)
    mask27 = xp.uint64((1 << 27) - 1)
    a0 = x & mask27
    a1 = (x >> xp.uint64(27)) & mask27
    a2 = x >> xp.uint64(54)                    # < 2^10
    c0 = xp.uint64(mg & ((1 << 27) - 1))
    c1 = xp.uint64(mg >> 27)
    l0 = a0 * c0
    l1 = a1 * c0 + a0 * c1
    l2 = a2 * c0 + a1 * c1
    l3 = a2 * c1                               # < 2^37
    lo_raw = l0 + ((l1 & mask27) << xp.uint64(27))
    hi = l2 + (l1 >> xp.uint64(27)) + (l3 << xp.uint64(27))
    hi = hi + (lo_raw >> xp.uint64(54))
    lo = lo_raw & ((one << xp.uint64(54)) - one)
    # product p = hi*2^54 + lo, value p * 2^-110; round at bit L-53
    L = _bitlen_u64(hi, xp) + 54               # p's bit length (hi > 0
    d = xp.maximum(L - 53 - 54, xp.int64(0))   # whenever x > 0)
    du = d.astype(xp.uint64)
    keep = hi >> du
    rem_hi = hi & ((one << du) - one)
    rhs_hi = xp.where(d >= 1, one << (xp.maximum(du, one) - one),
                      xp.uint64(0))
    rhs_lo = xp.where(d >= 1, xp.uint64(0), one << xp.uint64(53))
    gt = (rem_hi > rhs_hi) | ((rem_hi == rhs_hi) & (lo > rhs_lo))
    tie = (rem_hi == rhs_hi) & (lo == rhs_lo)
    up = gt | (tie & ((keep & one) == one))
    keep = keep + up.astype(xp.uint64)
    return xp.where(x == 0, xp.uint64(0), keep << du)


def _y_chain_u64(r, g, b, xp):
    """The rounded double sum S of the Y row, exact at scale 2^-56."""
    p1 = _rne_u64(xp.uint64(_MI_Y[0]) * r.astype(xp.uint64), 53, xp)
    p2 = _rne_u64(xp.uint64(_MI_Y[1]) * g.astype(xp.uint64), 53, xp)
    p3 = _rne_u64(xp.uint64(_MI_Y[2]) * b.astype(xp.uint64), 53, xp)
    return _rne_u64(_rne_u64(p1 + p2, 53, xp) + p3, 53, xp)


def _rne_i64(t, P: int, xp):
    """Sign-symmetric RNE (IEEE round-to-nearest is magnitude-only):
    signed scaled value -> rounded signed scaled value."""
    mag = _rne_u64(xp.abs(t).astype(xp.uint64), P, xp).astype(xp.int64)
    return xp.where(t < 0, -mag, mag)


def _chroma_chain_i64(r, g, b, M, sgn, xp):
    """The rounded double sum C of a chroma row at scale 2^-56: a
    single RNE53 of the exact rational sum (the collapse of the three
    per-operation roundings is proven bit-identical downstream by the
    exhaustive LOW3 sweep, exactly like the no-gain RNE24 collapse)."""
    t = (xp.int64(sgn[0] * M[0]) * r.astype(xp.int64)
         + xp.int64(sgn[1] * M[1]) * g.astype(xp.int64)
         + xp.int64(sgn[2] * M[2]) * b.astype(xp.int64))
    return _rne_i64(t, 53, xp)


def _chroma_out(c_int, xp):
    """Signed exact-scaled chroma double -> fl32 narrow ->
    +128.5f/+128.4f float32 add -> (int) trunc (all exact steps)."""
    c32 = _rne_u64(xp.abs(c_int).astype(xp.uint64), 24, xp)
    neg = c_int < 0
    w = xp.where(neg, xp.uint64(_HI_N) - c32, c32 + xp.uint64(_HI_P))
    ovf = (~neg) & (w < c32)        # C32 == +127.5 wraps at exactly 2^64
    out = (_rne_u64(w, 24, xp) >> xp.uint64(56)).astype(xp.int64)
    return xp.where(ovf, xp.int64(256), out)


def _clip_u8(v, xp):
    """The reference's (v>>8)!=0 clip pattern."""
    v = v.astype(xp.int32)
    return xp.where((v >> 8) != 0, xp.where(v < 0, 0, 255), v)


def _yuv_full(rgb, quality: int, xp, qtz=None):
    """(..., 512, 512, 3) uint8 -> (Y int16 ..., U, V uint8 512x512
    pre-downsample), replicating the per-quality matrix paths.
    ``qtz``: optional traced scalar override of the integer-path Qtz
    (lets the 16 q<=LOW4 qualities share one compiled program)."""
    r = rgb[..., 0].astype(xp.int32)
    g = rgb[..., 1].astype(xp.int32)
    b = rgb[..., 2].astype(xp.int32)

    if quality <= T.LOW4:
        if qtz is None:
            qtz = QTZ[quality]
        y = (((66 * r + 129 * g + 25 * b) * qtz + 4194304) >> 23) + 16
        u = (((-38 * r - 74 * g + 112 * b) * qtz + 4194304) >> 23) + 128
        v = (((112 * r - 94 * g - 18 * b) * qtz + 4194304) >> 23) + 128
        return (y.astype(xp.int16), _clip_u8(u, xp).astype(xp.uint8),
                _clip_u8(v, xp).astype(xp.uint8))

    if quality >= T.NORM:
        y = _y_fast(r, g, b, xp)
        u = _chroma_fast(r, g, b, _MI_U, (-1, -1, 1), xp)
        v = _chroma_fast(r, g, b, _MI_V, (1, -1, -1), xp)
        return (y.astype(xp.int16), _clip_u8(u, xp).astype(xp.uint8),
                _clip_u8(v, xp).astype(xp.uint8))

    # gain qualities (q17-19): exact replay + limb gain multiply
    s = _gain_mul_rne53(_y_chain_u64(r, g, b, xp),
                        _MI_GAIN[quality], xp)
    w = _rne_u64(s + xp.uint64(1 << 55), 53, xp)
    y = (w >> xp.uint64(56)).astype(xp.int64)
    if quality == T.LOW3:
        # chroma gain too: replayed signed chain, gain on the magnitude
        def _cg(M, sgn):
            c = _chroma_chain_i64(r, g, b, M, sgn, xp)
            mag = _gain_mul_rne53(xp.abs(c).astype(xp.uint64),
                                  _MI_GAIN[T.LOW3], xp).astype(xp.int64)
            return _chroma_out(xp.where(c < 0, -mag, mag), xp)

        u = _cg(_MI_U, (-1, -1, 1))
        v = _cg(_MI_V, (1, -1, -1))
    else:
        u = _chroma_fast(r, g, b, _MI_U, (-1, -1, 1), xp)
        v = _chroma_fast(r, g, b, _MI_V, (1, -1, -1), xp)
    return (y.astype(xp.int16), _clip_u8(u, xp).astype(xp.uint8),
            _clip_u8(v, xp).astype(xp.uint8))


def _down420(c, xp):
    """Integer 4:2:0 chroma downsample (encoder/colorspace.c:220-256):
    horizontal [1,2,1]/4 at even columns (first pair-averaged), then the
    same vertically.  (..., 512, 512) -> (..., 256, 256) uint8."""
    c = c.astype(xp.int32)
    h = xp.concatenate([
        (c[..., :, :1] + c[..., :, 1:2] + 1) >> 1,
        (c[..., :, 1:510:2] + 2 * c[..., :, 2:511:2]
         + c[..., :, 3:512:2] + 2) >> 2], axis=-1)
    o = xp.concatenate([
        (h[..., :1, :] + h[..., 1:2, :] + 1) >> 1,
        (h[..., 1:510:2, :] + 2 * h[..., 2:511:2, :]
         + h[..., 3:512:2, :] + 2) >> 2], axis=-2)
    return o.astype(xp.uint8)


def rgb_to_yuv420_host_exact(rgb: np.ndarray, quality: int):
    """Numpy replay of the device program (same code, xp=np) — used by
    the exhaustiveness tests to cross-check the jax path."""
    y, u, v = _yuv_full(np.asarray(rgb, np.uint8), quality, np)
    return y, _down420(u, np), _down420(v, np)


def program_key(quality: int) -> int:
    """Qualities sharing one compiled colorspace program: all q >= NORM
    share the plain float path; each gain quality is its own program;
    all integer-path qualities share one program (Qtz is a traced
    scalar)."""
    if quality >= T.NORM:
        return T.NORM
    if quality in (T.LOW1, T.LOW2, T.LOW3):
        return quality
    return T.LOW4


@functools.lru_cache(maxsize=None)
def _jitted(key: int):
    import jax
    import jax.numpy as jnp

    def run(rgb, qtz):
        with jax.named_scope("nhw.colorspace.matrix"):
            y, u, v = _yuv_full(rgb, key, jnp, qtz=qtz)
        with jax.named_scope("nhw.colorspace.down420"):
            return y, _down420(u, jnp), _down420(v, jnp)

    return jax.jit(run)


@functools.lru_cache(maxsize=None)
def _jitted_limb():
    """q >= NORM encode through the u32-limb chain (no x64 tracing,
    native 32-bit lanes end to end; proven equal to the _yuv_full NORM
    path over all 2^24 triples — tools/colorspace_limb_exhaustive.py)."""
    import jax
    import jax.numpy as jnp

    from nhwcodec_tpu.ops import colorspace_limb as cl

    def run(rgb):
        with jax.named_scope("nhw.colorspace.matrix"):
            y, u, v = cl.yuv_norm_limb(
                rgb[..., 0], rgb[..., 1], rgb[..., 2], jnp)
            y = y.astype(jnp.int16)
            u = _clip_u8(u, jnp).astype(jnp.uint8)
            v = _clip_u8(v, jnp).astype(jnp.uint8)
        with jax.named_scope("nhw.colorspace.down420"):
            return y, _down420(u, jnp), _down420(v, jnp)

    return jax.jit(run)


def rgb_to_yuv420_device_exact(rgb, quality: int):
    """Bit-exact batched device colorspace.  rgb: (..., 512, 512, 3)
    uint8 (device or host).  Returns (Y (..., 512,512) int16,
    U, V (..., 256,256) uint8) device arrays equal to the host path
    (ops.colorspace.downsample_yuv420) for every input and quality."""
    import jax
    import jax.numpy as jnp

    if quality >= T.NORM:
        return _jitted_limb()(rgb)
    qtz = jnp.int32(QTZ.get(quality, 0))
    with jax.enable_x64(True):
        return _jitted(program_key(quality))(rgb, qtz)


# ---------------------------------------------------------------------------
# decode direction: YUV -> RGB (decoder/nhw_decoder_cli.c:133-283)
#
# Same fixed-point-replay discipline as the encode side, at scale 2^54:
# every double in the float chains (y, the rounded products 1.402*vf
# etc., their left-to-right partial sums, +0.5) is a multiple of 2^-52
# with magnitude < 512, so the whole chain replays in signed int64 at
# scale 2^54 with a sign-symmetric RNE-to-53-bits after each operation.
# The gain multiply (q=LOW3) is an exact two-limb 77-bit product with a
# sticky-RNE53 whose rounding position is clamped at 2^-54 — coarser
# than fl64 only for |product| < 0.25, where the subsequent +0.5-and-
# trunc consumes the difference.  The q<=LOW4 integer path is float32
# end to end and replays at scale 2^23 with RNE-to-24-bits steps.

_MD_1402 = int(np.float64(1.402) * (1 << 54))
_MD_34414 = int(np.float64(0.34414) * (1 << 54))
_MD_71414 = int(np.float64(0.71414) * (1 << 54))
_MD_1772 = int(np.float64(1.772) * (1 << 54))
_HALF54 = 1 << 53
_HALF32_23 = int(np.float64(np.float32(128.5)) * (1 << 23))


def yinv_m23(quality: int) -> int:
    """Y_inv gain (a float32 constant) at scale 2^23 — exact for every
    table entry (f32 ulp >= 2^-23 at these magnitudes)."""
    m = float(np.float64(np.float32(T.Y_INV[quality])) * (1 << 23))
    assert m.is_integer()
    return int(m)


def _trunc_scaled(v, shift: int, xp):
    """C (int) cast: truncate a signed scaled integer toward zero."""
    return xp.where(v >= 0, v >> shift, -((-v) >> shift))


def _gain_mul_dec54(x, m23, xp):
    """fl64(yinv * t) for t = x * 2^-54 (signed 53-bit-mantissa double)
    and yinv = m23 * 2^-23 (f32-promoted double in (1, 2.1)): exact
    two-limb product, sticky-RNE to 53 bits at scale 2^-54 (rounding
    clamped at 2^-54; |yinv * t| < 512 keeps every limb in u64)."""
    one = xp.uint64(1)
    mask24 = xp.uint64((1 << 24) - 1)
    m = xp.asarray(m23).astype(xp.uint64)
    ax = xp.abs(x).astype(xp.uint64)
    a = ax >> xp.uint64(24)
    c = ax & mask24
    cm = c * m
    p_hi = a * m + (cm >> xp.uint64(24))       # value = p_hi*2^24 + p_lo
    p_lo = cm & mask24                         # at scale 2^77
    hi2 = (p_hi << one) | (p_lo >> xp.uint64(23))   # doubled: scale 2^78
    lo2 = (p_lo << one) & mask24
    L = _bitlen_u64(hi2, xp) + 24
    shift = xp.maximum(L - 53, xp.int64(24))
    s2 = (shift - 24).astype(xp.uint64)
    keep = hi2 >> s2
    rem2 = hi2 & ((one << s2) - one)
    half2 = (one << s2) >> one
    sticky = lo2 != 0
    up = xp.where(
        s2 > 0,
        (rem2 > half2) | ((rem2 == half2)
                          & (sticky | ((keep & one) == one))),
        (lo2 > xp.uint64(1 << 23)) | ((lo2 == xp.uint64(1 << 23))
                                      & ((keep & one) == one)))
    mag = ((keep + up.astype(xp.uint64)) << s2).astype(xp.int64)
    return xp.where(x < 0, -mag, mag)


def _dec_inner54(y54, uf, vf, xp):
    """The three pre-+0.5 double chains at scale 2^54 (left-to-right
    rounding): r' = y + 1.402*vf, g' = y - 0.34414*uf - 0.71414*vf,
    b' = y + 1.772*uf."""
    tr = _rne_i64(xp.int64(_MD_1402) * vf, 53, xp)
    ir = _rne_i64(y54 + tr, 53, xp)
    ta = _rne_i64(xp.int64(_MD_34414) * uf, 53, xp)
    tb = _rne_i64(xp.int64(_MD_71414) * vf, 53, xp)
    ig = _rne_i64(_rne_i64(y54 - ta, 53, xp) - tb, 53, xp)
    tc = _rne_i64(xp.int64(_MD_1772) * uf, 53, xp)
    ib = _rne_i64(y54 + tc, 53, xp)
    return ir, ig, ib


def _half_trunc54(t, xp):
    """trunc(fl64(t + 0.5)) at scale 2^54."""
    return _trunc_scaled(_rne_i64(t + xp.int64(_HALF54), 53, xp), 54, xp)


def _yuv_to_rgb_mode(y, u, v, m23, mode: int, xp):
    """One decode colorspace program.  mode 0: plain float (q>=NORM);
    1: LOW3 (gain inside the +0.5); 2: LOW1/LOW2 (float32 Y prescale);
    3: q<=LOW4 integer matrix + float32 gain.  m23: traced yinv scale-
    2^23 scalar (modes 1-3)."""
    y64 = y.astype(xp.int64)
    uf = u.astype(xp.int64) - 128
    vf = v.astype(xp.int64) - 128

    if mode == 3:
        yi = y64 * 298
        ui = u.astype(xp.int64)
        vi = v.astype(xp.int64)

        def chan(acc):
            p = _rne_i64(acc * m23, 24, xp)
            s = _rne_i64(p + xp.int64(_HALF32_23), 24, xp)
            return _trunc_scaled(s, 23, xp) >> 8

        r = chan(yi + 409 * vi + T.R_COMP)
        g = chan(yi - 100 * ui - 208 * vi + T.G_COMP)
        b = chan(yi + 516 * ui + T.B_COMP)
    else:
        if mode == 2:
            # yq = double(float32(y * yinv)): exact at 2^23, then 2^54
            y54 = _rne_i64(y64 * m23, 24, xp) << xp.int64(31)
        else:
            y54 = y64 << xp.int64(54)
        ir, ig, ib = _dec_inner54(y54, uf, vf, xp)
        if mode == 1:
            ir = _gain_mul_dec54(ir, m23, xp)
            ig = _gain_mul_dec54(ig, m23, xp)
            ib = _gain_mul_dec54(ib, m23, xp)
        r = _half_trunc54(ir, xp)
        g = _half_trunc54(ig, xp)
        b = _half_trunc54(ib, xp)

    rgb = xp.stack([r, g, b], axis=-1)
    return _clip_u8(rgb, xp).astype(xp.uint8)


def dec_mode(quality: int) -> int:
    if quality >= T.NORM:
        return 0
    if quality == T.LOW3:
        return 1
    if quality in (T.LOW1, T.LOW2):
        return 2
    return 3


@functools.lru_cache(maxsize=None)
def _jitted_dec(mode: int):
    import jax
    import jax.numpy as jnp

    def run(y, u, v, m23):
        with jax.named_scope("nhw.yuv_to_rgb"):
            return _yuv_to_rgb_mode(y, u, v, m23, mode, jnp)

    return jax.jit(run)


@functools.lru_cache(maxsize=None)
def _jitted_dec_limb():
    """Mode-0 decode through the u32-limb chain (no x64 tracing;
    proven equal to the _yuv_to_rgb_mode(0) path over all 2^24
    triples — tools/colorspace_limb_exhaustive.py)."""
    import jax
    import jax.numpy as jnp

    from nhwcodec_tpu.ops import colorspace_limb as cl

    def run(y, u, v):
        with jax.named_scope("nhw.yuv_to_rgb"):
            r, g, b = cl.rgb_mode0_limb(y, u, v, jnp)
            rgb = jnp.stack([r, g, b], axis=-1)
            return _clip_u8(rgb, jnp).astype(jnp.uint8)

    return jax.jit(run)


def yuv_to_rgb_host_exact(y, u, v, quality: int) -> np.ndarray:
    """Numpy replay of the device decode colorspace (same code, xp=np)."""
    m23 = np.int64(yinv_m23(quality) if quality < T.NORM else 0)
    return _yuv_to_rgb_mode(np.asarray(y, np.uint8), np.asarray(u, np.uint8),
                            np.asarray(v, np.uint8), m23,
                            dec_mode(quality), np)


def yuv_to_rgb_device_exact(y, u, v, quality: int):
    """Bit-exact batched device YUV->RGB: (..., 512, 512) uint8 planes ->
    (..., 512, 512, 3) uint8, equal to models.decoder.yuv_to_rgb
    (decoder/nhw_decoder_cli.c:133-283) for every input and quality."""
    import jax
    import jax.numpy as jnp

    if quality >= T.NORM:
        return _jitted_dec_limb()(y, u, v)
    m23 = jnp.int64(yinv_m23(quality) if quality < T.NORM else 0)
    with jax.enable_x64(True):
        return _jitted_dec(dec_mode(quality))(y, u, v, m23)
