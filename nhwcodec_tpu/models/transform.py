"""Batched on-device NHW transform pipelines (JAX/XLA).

This is the *device compute core* of the codec: the multi-level integer 5/3
lifting synthesis filterbank, chroma upsampling and YUV->RGB, expressed as
pure batched array programs over ``(B, H, W)`` planes.  Everything here is
jittable, vmappable and shardable with ``pjit`` over a device mesh (batch =
data-parallel axis).

The host pipeline (`models.decoder`) interleaves entropy decode and sparse
residue scatter-adds between these stages; on device the residues arrive as
pre-scattered coefficient planes, so the transform is one fused XLA program
per batch.

Integer semantics match the reference filterbank exactly
(decoder/wavelet_filterbank.c:52-235, decoder/filters.c:143-194): int32
arithmetic with int16 wraparound at every point the C stores to ``short``.
The final YUV->RGB here runs in float32 (the reference uses C doubles; the
bit-exact device form is ``ops.colorspace_device``, and the host path in
``models.decoder`` keeps float64 bit-exactness).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from nhwcodec_tpu.ops.lifting import synth_norm, synth_unnorm

D = 256
N = 512


def _t(x: jnp.ndarray) -> jnp.ndarray:
    """Transpose the trailing two (spatial) axes, batch dims untouched."""
    return jnp.swapaxes(x, -2, -1)


def synth_level(block: jnp.ndarray) -> jnp.ndarray:
    """One full 2-D synthesis level on an (..., 2M, 2M) coefficient block:
    un-normalized row pass, transpose, normalized row pass (the
    ``wavelet_synthesis(im, 2M, 0, Y)`` composition,
    decoder/wavelet_filterbank.c:52-235)."""
    m = block.shape[-1] // 2
    t1 = synth_unnorm(block[..., :, :m], block[..., :, m:], xp=jnp)
    t1 = _t(t1).astype(jnp.int16)
    return synth_norm(t1[..., :, :m], t1[..., :, m:], xp=jnp)


def decode_transform_y(coeff: jnp.ndarray) -> jnp.ndarray:
    """Y coefficient plane -> luma pixels.

    coeff: (..., 512, 512) int16 coefficient plane with LL2 at [:128,:128]
    (post entropy decode / residue scatter).  Returns (..., 512, 512) uint8.

    Mirrors the stage order of decoder/nhw_decoder.c:713-891 minus the
    sparse in-between passes (which the host applies to ``coeff`` /
    intermediate planes before calling in the bit-exact path).
    """
    coeff = jnp.asarray(coeff).astype(jnp.int16)
    # level 2: LL2(128) -> LL1(256), on the top-left 256x256 block
    blk = coeff[..., :D, :D]
    t1 = _t(synth_unnorm(blk[..., :, :128], blk[..., :, 128:], xp=jnp)
            ).astype(jnp.int16)
    ll1 = synth_norm(t1[..., :, :128], t1[..., :, 128:], xp=jnp)
    # transpose LL1 back into the coefficient plane (decoder:841-844)
    coeff = coeff.at[..., :D, :D].set(_t(ll1).astype(jnp.int16))
    # level 1 columns (x8 domain), transpose, final row pass, clip
    t2 = _t(synth_unnorm(coeff[..., :, :D], coeff[..., :, D:], xp=jnp)
            ).astype(jnp.int16)
    y = synth_norm(t2[..., :, :D], t2[..., :, D:], xp=jnp)
    return jnp.clip(y, 0, 255).astype(jnp.uint8)


def upsample2x(plane: jnp.ndarray) -> jnp.ndarray:
    """Bilinear x2 chroma upsample, vertical then horizontal
    (decoder/nhw_decoder.c:1137-1181).  (..., 256, 256) -> (..., 512, 512)."""
    p = plane.astype(jnp.int32)
    lead = p.shape[:-2]
    mid = (p[..., : D - 1, :] + p[..., 1:, :] + 1) >> 1
    v = jnp.stack([p[..., : D - 1, :], mid], axis=-2)
    v = v.reshape(lead + (2 * (D - 1), D))
    last = jnp.broadcast_to(p[..., D - 1 :, :], lead + (2, D))
    v = jnp.concatenate([v, last], axis=-2)

    midh = (v[..., :, : D - 1] + v[..., :, 1:] + 1) >> 1
    h = jnp.stack([v[..., :, : D - 1], midh], axis=-1)
    h = h.reshape(lead + (N, 2 * (D - 1)))
    lasth = jnp.broadcast_to(v[..., :, D - 1 :], lead + (N, 2))
    h = jnp.concatenate([h, lasth], axis=-1)
    return h.astype(jnp.uint8)


def decode_transform_uv(coeff: jnp.ndarray) -> jnp.ndarray:
    """Chroma coefficient plane -> upsampled chroma pixels.

    coeff: (..., 256, 256) int16 with LL2 at [:64,:64].
    Returns (..., 512, 512) uint8 (decoder/nhw_decoder.c:981-1181 stage
    order, minus sparse sentinel/sharpen passes).
    """
    coeff = jnp.asarray(coeff).astype(jnp.int16)
    blk = coeff[..., :128, :128]
    t1 = _t(synth_unnorm(blk[..., :, :64], blk[..., :, 64:], xp=jnp)
            ).astype(jnp.int16)
    ll1 = synth_norm(t1[..., :, :64], t1[..., :, 64:], xp=jnp)
    coeff = coeff.at[..., :128, :128].set(_t(ll1).astype(jnp.int16))
    t2 = _t(synth_unnorm(coeff[..., :, :128], coeff[..., :, 128:], xp=jnp)
            ).astype(jnp.int16)
    uv = synth_norm(t2[..., :, :128], t2[..., :, 128:], xp=jnp)
    uv = jnp.clip(uv, 0, 255).astype(jnp.int16)
    return upsample2x(uv)


def yuv_to_rgb_device(y: jnp.ndarray, u: jnp.ndarray,
                      v: jnp.ndarray) -> jnp.ndarray:
    """Float YUV->RGB (JPEG matrix, the q>=20 path of
    decoder/nhw_decoder_cli.c:133-166) in float32 on device."""
    yf = y.astype(jnp.float32)
    uf = u.astype(jnp.float32) - 128.0
    vf = v.astype(jnp.float32) - 128.0
    r = yf + 1.402 * vf + 0.5
    g = yf - 0.34414 * uf - 0.71414 * vf + 0.5
    b = yf + 1.772 * uf + 0.5
    rgb = jnp.trunc(jnp.stack([r, g, b], axis=-1)).astype(jnp.int32)
    out = jnp.where((rgb >> 8) != 0, jnp.where(rgb < 0, 0, 255), rgb)
    return out.astype(jnp.uint8)


def decode_transform(y_coeff: jnp.ndarray, u_coeff: jnp.ndarray,
                     v_coeff: jnp.ndarray) -> jnp.ndarray:
    """Full batched device decode transform: coefficient planes -> RGB.

    y_coeff: (..., 512, 512) int16;  u_coeff, v_coeff: (..., 256, 256) int16.
    Returns (..., 512, 512, 3) uint8.
    """
    y = decode_transform_y(y_coeff)
    u = decode_transform_uv(u_coeff)
    v = decode_transform_uv(v_coeff)
    return yuv_to_rgb_device(y, u, v)


# Analysis (encoder-side) counterpart lives in ops.analysis once the encoder
# lands; decode_transform is the flagship inference step for the entry point.


decode_transform_jit = jax.jit(decode_transform)


# ---------------------------------------------------------------------------
# Encode transform: batched 2-level analysis (the encoder's device core).
# Mirrors ops.analysis (encoder/wavelet_filterbank.c:52-302) functionally:
# no in-place buffer dance, planes are values.

from nhwcodec_tpu.ops.analysis import down_53, down_iv, down_vi


def _analysis_level(plane: jnp.ndarray, res_high: int = 0) -> jnp.ndarray:
    """One full 2-D analysis level on an (..., M, M) block: horizontal raw
    IV pass, transpose, per-half column filters (VI top / plain 53
    bottom), LL-quadrant transpose-back.  Returns the (..., M, M) subband
    layout the reference leaves in its process plane, with the LL quadrant
    already transposed back."""
    m = plane.shape[-1]
    h = m // 2
    low, high = down_iv(plane, xp=jnp)
    t = _t(jnp.concatenate([low, high], axis=-1).astype(jnp.int16))
    top_l, top_h = down_vi(t[..., :h, :], xp=jnp)
    bot_l, bot_h = down_53(t[..., h:, :], xp=jnp)
    out = jnp.concatenate([
        jnp.concatenate([top_l, top_h], axis=-1),
        jnp.concatenate([bot_l, bot_h], axis=-1)], axis=-2).astype(jnp.int16)
    return out.at[..., :h, :h].set(_t(out[..., :h, :h]))


def encode_transform_y(y: jnp.ndarray) -> jnp.ndarray:
    """(..., 512, 512) int16 luma -> 2-level coefficient plane: level-1
    subbands with the level-2 decomposition of the LL quadrant in place
    (the working layout of encoder/nhw_encoder.c:125-139)."""
    y = jnp.asarray(y).astype(jnp.int16)
    l1 = _analysis_level(y)
    l2 = _analysis_level(l1[..., :D, :D])
    # the second level's result stays transposed in the reference's
    # process plane; keep the natural orientation here (device layout)
    return l1.at[..., :D, :D].set(l2)


def encode_transform_uv(c: jnp.ndarray) -> jnp.ndarray:
    """(..., 256, 256) int16 chroma -> 2-level coefficient plane."""
    c = jnp.asarray(c).astype(jnp.int16)
    l1 = _analysis_level(c)
    l2 = _analysis_level(l1[..., :128, :128])
    return l1.at[..., :128, :128].set(l2)


def rgb_to_yuv420_device(rgb: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray,
                                                    jnp.ndarray]:
    """Batched device colorspace (float32; the exact-double host path is
    ops.colorspace).  rgb: (..., 512, 512, 3) uint8."""
    r = rgb[..., 0].astype(jnp.float32)
    g = rgb[..., 1].astype(jnp.float32)
    b = rgb[..., 2].astype(jnp.float32)
    y = jnp.trunc(0.299 * r + 0.587 * g + 0.114 * b + 0.5).astype(jnp.int16)
    cb = -0.1687 * r - 0.3313 * g + 0.5 * b
    cr = 0.5 * r - 0.4187 * g - 0.0813 * b
    # sign-dependent rounding constant per encoder/colorspace.c:76-81
    # (+128.4f for negative chroma); float32 precision loss vs the
    # reference's double sums remains — the bit-exact device colorspace
    # is ops.colorspace_device
    half = jnp.where(cb >= 0, jnp.float32(128.5), jnp.float32(128.4))
    u = jnp.clip(jnp.trunc(cb + half), 0, 255).astype(jnp.int32)
    half = jnp.where(cr >= 0, jnp.float32(128.5), jnp.float32(128.4))
    v = jnp.clip(jnp.trunc(cr + half), 0, 255).astype(jnp.int32)

    def down(c):
        h = jnp.concatenate([
            (c[..., :, :1] + c[..., :, 1:2] + 1) >> 1,
            (c[..., :, 1:510:2] + 2 * c[..., :, 2:511:2]
             + c[..., :, 3:512:2] + 2) >> 2], axis=-1)
        o = jnp.concatenate([
            (h[..., :1, :] + h[..., 1:2, :] + 1) >> 1,
            (h[..., 1:510:2, :] + 2 * h[..., 2:511:2, :]
             + h[..., 3:512:2, :] + 2) >> 2], axis=-2)
        return o.astype(jnp.int16)

    return y, down(u), down(v)


def encode_transform(rgb: jnp.ndarray):
    """Full batched device encode transform: (..., 512, 512, 3) uint8 ->
    (y_coeff (..., 512,512) i16, u_coeff, v_coeff (..., 256,256) i16)."""
    y, u, v = rgb_to_yuv420_device(rgb)
    return (encode_transform_y(y), encode_transform_uv(u),
            encode_transform_uv(v))


encode_transform_jit = jax.jit(encode_transform)
