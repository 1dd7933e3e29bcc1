"""Device front-end of the bit-exact encode pipeline.

Functional (batched, jittable) replicas of the host encoder's in-place
transform stages, producing the exact (jpeg, process, res256, snap)
state the host scans consume:

- Y:   wavelet_analysis(512, 0) -> res256 snapshot -> wavelet_analysis(256, 1)
       (encoder/nhw_encoder.c:121-139 / encoder/wavelet_filterbank.c:52-302)
- UV:  pre_processing_UV (q<=LOW6) -> wavelet_analysis(256, 0) -> res256
       -> LOW4 band dead-zone -> wavelet_analysis(128, 1)
       (encoder/nhw_encoder.c:2256-2314 / image_processing.c:2428-2464)

plus the fused colorspace+analysis launch for the q>HIGH1 path (no Y
pre-filter at q>=22, so the whole front end is one device program).

Integer semantics are shared with the host via ops.analysis filters
(xp=jnp); equality vs the in-place host functions is tested in
tests/test_device_stages.py and end-to-end byte-exactness in
tests/test_device_encode.py.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from nhwcodec_tpu import tables as T
from nhwcodec_tpu.ops.analysis import down_53, down_iv, down_vi

D = 256
N = 512


def _t(x):
    return jnp.swapaxes(x, -2, -1)


def _cat2(low, high):
    return jnp.concatenate([low, high], axis=-1).astype(jnp.int16)


def _stage_xla(jpeg_blk):
    """One wavelet_analysis level on an (..., M, M) block given the
    block content of ``jpeg``: returns (jpeg_blk', process_blk) exactly
    as the in-place host driver leaves them *before* the LL
    transpose-back (which depends on last_stage)."""
    low, high = down_iv(jpeg_blk, xp=jnp)
    p = _cat2(low, high)
    j = _t(p)
    m = jpeg_blk.shape[-1] // 2
    tl, th = down_vi(j[..., :m, :], xp=jnp)
    bl, bh = down_53(j[..., m:, :], xp=jnp)
    p = jnp.concatenate([_cat2(tl, th), _cat2(bl, bh)], axis=-2)
    return j, p


def analysis_y(y):
    """(..., 512, 512) int16 pre-processed luma -> (jpeg, process,
    res256, snap): the exact post-second-analysis state of encode_y
    (models/encoder.py) before the requant ladder."""
    y = jnp.asarray(y).astype(jnp.int16)
    with jax.named_scope("nhw.analysis_y.level1"):
        j1, p1 = _stage_xla(y)
    snap = j1[..., :D, :]                      # flat [:2*IM_SIZE] rows
    jpeg = j1.at[..., :D, :D].set(_t(p1[..., :D, :D]))
    res256 = jpeg[..., :D, :D]
    with jax.named_scope("nhw.analysis_y.level2"):
        j2, p2 = _stage_xla(res256)
    process = p1.at[..., :D, :D].set(p2)
    jpeg = jpeg.at[..., :D, :D].set(j2)        # last_stage: no LL put-back
    return jpeg, process, res256, snap


def _pre_processing_uv_device(jpeg, quality: int):
    """8-neighbour laplacian nudge (encoder/image_processing.c:2428-2464),
    device replica of models.encoder._pre_processing_uv."""
    p = jpeg.astype(jnp.int32)
    lap = jnp.zeros_like(p)
    core = ((p[..., 1:-1, 1:-1] << 3)
            - p[..., 1:-1, :-2] - p[..., 1:-1, 2:]
            - p[..., :-2, 1:-1] - p[..., 2:, 1:-1]
            - p[..., :-2, :-2] - p[..., 2:, :-2]
            - p[..., :-2, 2:] - p[..., 2:, 2:])
    lap = lap.at[..., 1:-1, 1:-1].set(core)
    if quality < T.LOW6:
        d = jnp.where(jnp.abs(lap) >= 14, 2,
                      jnp.where(jnp.abs(lap) > 5, 1, 0))
        return (jpeg - (jnp.sign(lap) * d).astype(jnp.int16)
                ).astype(jnp.int16)
    return (jpeg - jnp.where(lap > 5, 1,
                             jnp.where(lap < -5, -1, 0)).astype(jnp.int16)
            ).astype(jnp.int16)


def analysis_uv(c, quality: int):
    """(..., 256, 256) uint8 downsampled chroma -> (jpeg, process,
    res256): the exact encode_uv state after its second analysis
    (encoder/nhw_encoder.c:2256-2314), incl. the q<=LOW6 pre-filter and
    the q<=LOW4 band dead-zone."""
    jpeg = jnp.asarray(c).astype(jnp.int16)
    if quality <= T.LOW6:
        # (the reference also copies jpeg into process first; that copy
        # is fully overwritten by the first analysis level)
        with jax.named_scope("nhw.analysis_uv.prefilter"):
            jpeg = _pre_processing_uv_device(jpeg, quality)
    with jax.named_scope("nhw.analysis_uv.level1"):
        j1, p1 = _stage_xla(jpeg)
    jpeg = j1.at[..., :128, :128].set(_t(p1[..., :128, :128]))
    res256 = jpeg[..., :128, :128]

    if quality <= T.LOW4:
        # band dead-zones before the second level (encode_uv LOW4 pass)
        def dz(v, lo, hi):
            a = jnp.abs(v.astype(jnp.int32))
            return jnp.where((a >= lo) & (a < hi), 0, v).astype(jnp.int16)

        p1 = p1.at[..., :128, 128:].set(dz(p1[..., :128, 128:], 8, 24))
        p1 = p1.at[..., 128:, :128].set(dz(p1[..., 128:, :128], 8, 32))
        p1 = p1.at[..., 128:, 128:].set(dz(p1[..., 128:, 128:], 8, 48))

    with jax.named_scope("nhw.analysis_uv.level2"):
        j2, p2 = _stage_xla(res256)
    process = p1.at[..., :128, :128].set(p2)
    jpeg = jpeg.at[..., :128, :128].set(j2)
    return jpeg, process, res256


def _uv_program_key(quality: int) -> int:
    """Qualities sharing one compiled analysis program.  The only
    q-dependent branches are the UV pre-filter (q <= LOW6 == 14, 2-step
    variant below LOW6) and the band dead-zone (q <= LOW4 == 16):
    q>16 -> neither;  16,15 -> dead-zone only;  14 -> 1-step pre-filter
    + dead-zone;  <=13 -> 2-step pre-filter + dead-zone."""
    if quality > T.LOW4:
        return T.NORM
    if quality > T.LOW6:
        return T.LOW4
    if quality == T.LOW6:
        return T.LOW6
    return T.LOW7


@functools.lru_cache(maxsize=None)
def _jitted_analysis(key: int):
    def run(y, u, v):
        yj, yp, yr, ys = analysis_y(y)
        uj, up, ur = analysis_uv(u, key)
        vj, vp, vr = analysis_uv(v, key)
        return (yj, yp, yr, ys), (uj, up, ur), (vj, vp, vr)

    return jax.jit(run)


def analysis_front_device(y, u, v, quality: int):
    """Batched device analysis of the (possibly host-pre-filtered) Y
    plane and downsampled chroma planes.  Returns host numpy trees
    ((y_jpeg, y_process, y_res256, y_snap), (u_jpeg, u_process,
    u_res256), (v_...)) ready for the host scans."""
    out = _jitted_analysis(_uv_program_key(quality))(y, u, v)
    return jax.tree_util.tree_map(np.asarray, out)


@functools.lru_cache(maxsize=None)
def _jitted_front(key: int):
    from nhwcodec_tpu.ops import colorspace_device as csd

    def run(rgb):
        # callers are q > HIGH1 only, which share the NORM program:
        # plain float colorspace, no UV pre-filter, no dead-zone
        y, u, v = csd._yuv_full(rgb, key, jnp)
        u = csd._down420(u, jnp)
        v = csd._down420(v, jnp)
        yj, yp, yr, ys = analysis_y(y)
        uj, up, ur = analysis_uv(u, key)
        vj, vp, vr = analysis_uv(v, key)
        return (y, u, v), (yj, yp, yr, ys), (uj, up, ur), (vj, vp, vr)

    return jax.jit(run)


def encode_front_device(rgb, quality: int):
    """Fused single-launch front end (colorspace + analysis) for the
    qualities with no Y pre-filter (q > HIGH1): RGB batch in, all
    transform state out.  x64-traced for the softfloat lanes."""
    assert quality > T.HIGH1, "fused front end: q>HIGH1 only"
    with jax.enable_x64(True):
        out = _jitted_front(T.NORM)(rgb)
    return jax.tree_util.tree_map(np.asarray, out)


@functools.lru_cache(maxsize=None)
def _jitted_analysis_sharded(mesh, axis: str, key: int):
    from jax.sharding import PartitionSpec as P

    def run(y, u, v):
        yj, yp, yr, ys = analysis_y(y)
        uj, up, ur = analysis_uv(u, key)
        vj, vp, vr = analysis_uv(v, key)
        return (yj, yp, yr, ys), (uj, up, ur), (vj, vp, vr)

    sp = P(axis)
    return jax.jit(jax.shard_map(
        run, mesh=mesh, in_specs=(sp, sp, sp),
        out_specs=((sp,) * 4, (sp,) * 3, (sp,) * 3)))


def analysis_front_sharded(mesh, y, u, v, quality: int, axis: str = "data"):
    """Batch-sharded exact analysis via ``shard_map``: each shard runs
    the full per-image program on its own card.  Per-image compute has
    no cross-shard edges; no collectives are inserted.  Returns host
    numpy trees like analysis_front_device."""
    f = _jitted_analysis_sharded(mesh, axis, _uv_program_key(quality))
    return jax.tree_util.tree_map(np.asarray, f(y, u, v))


def colorspace_front_device(rgb, quality: int):
    """Device colorspace only (the q < HIGH2 path: the host Y pre-filter
    runs between colorspace and analysis)."""
    from nhwcodec_tpu.ops import colorspace_device as csd

    y, u, v = csd.rgb_to_yuv420_device_exact(rgb, quality)
    return np.asarray(y), np.asarray(u), np.asarray(v)
