"""Device back end of the bit-exact decode pipeline.

Batched, jittable replicas of the decoder's synthesis stages
(models.decoder.decode_y_back / decode_uv_synth).  The split mirrors the
encode side: the inherently raster-sequential automata stay on host, the
plane transforms run on the device.

- host front:   container parse, Huffman decode, positional streams,
                sentinel expansion, LL2/res4/exw, isolated smoothing
                (decoder/nhw_decoder.c:54-711)
- device 1:     Y level-2 synthesis + transform-domain residue scatter
                (:713-787); full UV synthesis including the residue
                sentinels as vectorized masked adds (:981-1079)
- host:         Y dering mark pass (sequential Gauss-Seidel, :789-839),
                UV sharpen (:1082-1109) + clip + upsample
- device 2:     Y level-1 synthesis + HQ injection + mark smoothing (a
                ``lax.scan`` over the mark list — live reads, exactly the
                reference's in-order pass) + final row synthesis + clip
                (:841-891)

The device programs are quality-independent: every per-q branch lives in
the host front, which hands the back end nothing but planes and padded
(index, delta) scatter pairs.  Bit-exact equality vs the host back end:
tests/test_device_decode.py; byte-identical BMPs end to end:
decode_batch_device below.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from nhwcodec_tpu.ops.lifting import synth_norm, synth_unnorm

D = 256
N = 512
SZ = 65536


def _t(x):
    return jnp.swapaxes(x, -2, -1)


def _synth_level(blk):
    """One full 2-D synthesis level (row un-norm pass, transpose, norm
    pass — wavelet_synthesis(im, 2M) as composed by decode_y_back) as
    slice algebra.  Returns int16."""
    m = blk.shape[-1] // 2
    t1 = synth_unnorm(blk[..., :m], blk[..., m:], xp=jnp).astype(jnp.int16)
    return synth_norm(_t(t1)[..., :m], _t(t1)[..., m:],
                      xp=jnp).astype(jnp.int16)


def _scatter_add(flat, idx, delta):
    """flat: (B, L) int16, idx: (B, K) int32 (0-padded), delta: (B, K)
    int16 (0-padded).  np.add.at semantics (duplicates accumulate)."""
    bidx = jnp.arange(flat.shape[0], dtype=jnp.int32)[:, None]
    return flat.at[bidx, idx].add(delta)


@jax.jit
def y_stage1_device(jpeg, idx, delta):
    """(B,512,512) int16 coefficient plane + padded transform-domain
    scatter -> (B,256,256) int16 LL1 proc block (decode_y_back through
    the residue add-back; the scatter rows beyond 255 land outside the
    block and are never read, exactly like the host's 512-stride
    slack)."""
    b = jpeg.shape[0]
    with jax.named_scope("nhw.decode.y_l2_synth"):
        ll1 = _synth_level(jpeg[:, :D, :D])
    # scratch covers only rows 0..255 of the host's 512-stride plane:
    # scatter indices >= D*N land in rows the host never reads, so the
    # explicit 'drop' mode reproduces them exactly at half the traffic
    buf = jnp.zeros((b, D, N), jnp.int16).at[:, :, :D].set(ll1)
    with jax.named_scope("nhw.decode.y_residue_scatter"):
        bidx = jnp.arange(b, dtype=jnp.int32)[:, None]
        flat = buf.reshape(b, -1).at[bidx, idx].add(delta, mode="drop")
    return flat.reshape(b, D, N)[:, :, :D]


@jax.jit
def y_stage2_device(jpeg, proc_ll1, hq_idx, hq_delta, marks, marks_valid):
    """Post-dering continuation: transpose LL1 back into the coefficient
    plane, level-1 row synthesis, HQ residue scatter, transpose, mark
    smoothing scan, final row synthesis, clip -> (B,512,512) uint8.

    marks: (B, K) int32 packed row*256+col records (pad with (1<<8)|1 —
    a safe in-bounds read — and marks_valid False)."""
    b = jpeg.shape[0]
    jp = jpeg.at[:, :D, :D].set(_t(proc_ll1))
    with jax.named_scope("nhw.decode.y_l1_synth"):
        t = synth_unnorm(jp[..., :D], jp[..., D:], xp=jnp).astype(jnp.int16)
    with jax.named_scope("nhw.decode.y_hq_scatter"):
        flat = _scatter_add(t.reshape(b, -1), hq_idx, hq_delta)
    x8 = _t(flat.reshape(b, N, N)).reshape(b, -1)

    def smooth_one(plane, recs, valid):
        def body(p, rv):
            rec, v = rv
            scan = ((rec >> 8) << 10) + (rec & 255)

            def g(off):
                return p[scan + off].astype(jnp.int32)

            c, le, ri = g(0), g(-1), g(1)
            up, dn = g(-N), g(N)
            res = ((c << 3) - le - ri - up - dn
                   - g(-N - 1) - g(N - 1) - g(-N + 1) - g(N + 1))
            new = ((c << 2) + le + ri + up + dn + 4) >> 3
            take = v & (jnp.abs(res) < 116)
            p = p.at[scan].set(
                jnp.where(take, new.astype(jnp.int16), p[scan]))
            return p, None

        plane, _ = jax.lax.scan(body, plane, (recs, valid))
        return plane

    with jax.named_scope("nhw.decode.y_mark_smooth"):
        x8 = jax.vmap(smooth_one)(x8, marks, marks_valid)

    jp = x8.reshape(b, N, N)
    with jax.named_scope("nhw.decode.y_final_synth"):
        y = synth_norm(jp[..., :D], jp[..., D:], xp=jnp)
    return jnp.clip(y, 0, 255).astype(jnp.uint8)


def _uv_sentinel_deltas(vals):
    """Masked sentinel decode (decoder/nhw_decoder.c:991-1069): value
    plane -> (delta at tgt, delta at tgt+1, clear mask)."""
    v = vals.astype(jnp.int32)
    pair = jnp.where(v == 5005, -4, jnp.where(v == 5006, 4, 0))
    single = jnp.where(v == 5003, -6, jnp.where(v == 5004, 6, 0))
    d0 = (pair + single).astype(jnp.int16)
    d1 = pair.astype(jnp.int16)
    clear = (v >= 5003) & (v <= 5006)
    return d0, d1, clear


@jax.jit
def uv_synth_device(jpeg):
    """(B,256,256) int16 chroma coefficient plane -> (B,256,256) int16
    pre-sharpen plane (decode_uv_synth replica; the residue sentinels
    are independent scatter-adds, applied as masked slice adds)."""
    b = jpeg.shape[0]
    with jax.named_scope("nhw.decode.uv_l2_synth"):
        ll1 = _synth_level(jpeg[:, :128, :128])
    proc = jnp.zeros((b, D, D), jnp.int16).at[:, :128, :128].set(ll1)

    with jax.named_scope("nhw.decode.uv_sentinels"):
        # upper-right band: scan=(r,128+c), tgt=(r,c)
        d0, d1, clear = _uv_sentinel_deltas(jpeg[:, :128, 128:])
        proc = proc.at[:, :128, :128].add(d0)
        proc = proc.at[:, :128, 1:129].add(d1)
        jpeg = jpeg.at[:, :128, 128:].set(
            jnp.where(clear, jnp.int16(0), jpeg[:, :128, 128:]))

        # lower half: scan=(128+r,c), tgt=(r,c) for c<128 / (r,c-128)
        for sl in (slice(0, 128), slice(128, 256)):
            d0, d1, clear = _uv_sentinel_deltas(jpeg[:, 128:, sl])
            proc = proc.at[:, :128, :128].add(d0)
            proc = proc.at[:, :128, 1:129].add(d1)
            jpeg = jpeg.at[:, 128:, sl].set(
                jnp.where(clear, jnp.int16(0), jpeg[:, 128:, sl]))

    jp = jpeg.at[:, :128, :128].set(_t(proc[:, :128, :128]))
    with jax.named_scope("nhw.decode.uv_l1_synth"):
        return _synth_level(jp)


# ---------------------------------------------------------------------------
# host-side padding + batch orchestration


def _bucket(n: int, lo: int = 8) -> int:
    k = lo
    while k < n:
        k <<= 1
    return k


def pad_scatter(pairs) -> tuple[np.ndarray, np.ndarray]:
    """[(idx, delta)] per image -> (B, K) int32/int16 zero-padded (index
    0 + delta 0 is a no-op add)."""
    k = _bucket(max((len(i) for i, _ in pairs), default=0))
    b = len(pairs)
    idx = np.zeros((b, k), np.int32)
    dl = np.zeros((b, k), np.int16)
    for n, (i, d) in enumerate(pairs):
        idx[n, : len(i)] = i
        dl[n, : len(i)] = d
    return idx, dl


@functools.partial(jax.jit, static_argnames=("n_waves",))
def y_stage2_dense_device(jpeg, proc_ll1, hq_idx, hq_delta, depth_plane,
                          n_waves: int):
    """y_stage2_device with the dering mark smoothing as DENSE depth
    waves instead of a per-mark sequential scan.

    Mark positions in the transposed plane are (2*row, col<256): every
    write lands on an EVEN plane row while reads span rows 2r-1..2r+1,
    so two marks interact only at the same row with |dcol| <= 1 —
    chains are horizontal runs, and a mark's wave number is its run
    position (host-computed ``depth_plane``, 0 = no mark).  Marks in
    one wave are pairwise non-adjacent, so a full-plane masked update
    reproduces the C's in-order semantics exactly; the host guards
    that same-row marks were emitted in increasing column order and
    falls back to the sequential scan otherwise (decode_batch_device).
    The loop runs n_waves steps (the longest run, a few dozen at most)
    instead of one step per mark (thousands on textured content)."""
    b = jpeg.shape[0]
    jp = jpeg.at[:, :D, :D].set(_t(proc_ll1))
    if hq_idx is None:
        hq_idx = jnp.zeros((b, 8), jnp.int32)
        hq_delta = jnp.zeros((b, 8), jnp.int16)
    with jax.named_scope("nhw.decode.y_l1_synth"):
        t = synth_unnorm(jp[..., :D], jp[..., D:], xp=jnp).astype(jnp.int16)
    with jax.named_scope("nhw.decode.y_hq_scatter"):
        flat = _scatter_add(t.reshape(b, -1), hq_idx, hq_delta)
    x8 = _t(flat.reshape(b, N, N))

    with jax.named_scope("nhw.decode.y_mark_waves"):
        dp = depth_plane.astype(jnp.int32)

        def wave(r, x):
            c = x.astype(jnp.int32)
            le = jnp.roll(c, 1, axis=2)
            ri = jnp.roll(c, -1, axis=2)
            up = jnp.roll(c, 1, axis=1)
            dn = jnp.roll(c, -1, axis=1)
            ul = jnp.roll(up, 1, axis=2)
            ur = jnp.roll(up, -1, axis=2)
            dl = jnp.roll(dn, 1, axis=2)
            dr = jnp.roll(dn, -1, axis=2)
            res = (c << 3) - le - ri - up - dn - ul - ur - dl - dr
            new = ((c << 2) + le + ri + up + dn + 4) >> 3
            take = (dp == r) & (jnp.abs(res) < 116)
            return jnp.where(take, new.astype(jnp.int16), x)

        x8 = jax.lax.fori_loop(1, n_waves + 1, wave, x8)

    with jax.named_scope("nhw.decode.y_final_synth"):
        y = synth_norm(x8[..., :D], x8[..., D:], xp=jnp)
    return jnp.clip(y, 0, 255).astype(jnp.uint8)


def mark_depth_planes(marks_list):
    """Per-image packed mark records -> ((B,512,512) uint8 depth plane
    in transposed-plane coordinates, n_waves, ok).  ok=False when some
    image emitted same-row marks out of column order (never observed;
    the caller then uses the sequential scan)."""
    b = len(marks_list)
    dp = np.zeros((b, N, N), np.uint8)
    n_waves = 1
    for n, m in enumerate(marks_list):
        if not m:
            continue
        a = np.asarray(m, np.int64)
        rows = a >> 8
        cols = a & 255
        for r in np.unique(rows):
            cs = cols[rows == r]
            if cs.size > 1 and not np.all(np.diff(cs) > 0):
                return None, 0, False
        grid = np.zeros((256, 257), bool)
        grid[rows, cols] = True
        idx = np.arange(257)
        start = np.where(grid & ~np.roll(grid, 1, axis=1), idx, -1)
        start[:, 0] = np.where(grid[:, 0], 0, -1)
        rs = np.maximum.accumulate(start, axis=1)
        rp = np.where(grid, idx - rs + 1, 0).astype(np.uint8)
        dp[n, 2 * rows, cols] = rp[rows, cols]
        n_waves = max(n_waves, int(rp.max()))
    return dp, n_waves, True


def pad_marks(marks_list) -> tuple[np.ndarray, np.ndarray]:
    """Per-image mark record lists -> ((B, K) int32 recs, (B, K) bool)."""
    k = _bucket(max((len(m) for m in marks_list), default=0))
    b = len(marks_list)
    recs = np.full((b, k), (1 << 8) | 1, np.int32)
    valid = np.zeros((b, k), bool)
    for n, m in enumerate(marks_list):
        recs[n, : len(m)] = m
        valid[n, : len(m)] = True
    return recs, valid


def decode_batch_device(datas, entropy_on_device: bool = False
                        ) -> list[np.ndarray]:
    """Batched bit-exact decode with the synthesis back end on device:
    .nhw byte strings -> (512,512,3) uint8 RGB arrays, byte-identical to
    models.decoder.decode (tests/test_device_decode.py).

    ``entropy_on_device``: run the Huffman unpackers on the device too
    (ops.entropy_decode_device — one batched launch pipeline each for
    the Y streams and the UV streams) instead of the host C automata;
    output is bit-identical either way."""
    from nhwcodec_tpu.models import decoder as dec
    from nhwcodec_tpu.ops import dc_plane, entropy
    from nhwcodec_tpu.utils.container import parse_nhw

    b = len(datas)
    parsed = [parse_nhw(data) for data in datas]
    sym_ys: list = [None] * b
    sym_uvs: list = [None] * b
    if entropy_on_device:
        from nhwcodec_tpu.ops import entropy_decode_device as edd

        sym_ys = edd.decode_y_device_batch(parsed)
        sym_uvs = edd.decode_uv_device_batch(parsed)

    ys, scats, hqs = [], [], []
    us, vs, quals = [], [], []
    for i, s in enumerate(parsed):
        res_comp = dc_plane.decode_dc_planes(
            s.res_ch, s.highres_comp, s.res_U_64, s.res_V_64,
            s.quality, s.res_high)
        jpeg, scat, hq = dec.decode_y_front(s, res_comp, sym=sym_ys[i])
        ys.append(jpeg.reshape(N, N))
        scats.append(scat)
        hqs.append(hq)
        sym_uv = (sym_uvs[i] if entropy_on_device
                  else entropy.decode_uv(s.packet2, s.tree2, s.tree_end))
        exw1 = dec._y_exw_end(s)
        ju, exw1 = dec.decode_uv_front(s, res_comp, sym_uv, 0, exw1 + 2)
        jv, _ = dec.decode_uv_front(s, res_comp, sym_uv, 1, exw1 + 2)
        us.append(ju.reshape(D, D))
        vs.append(jv.reshape(D, D))
        quals.append(s.quality)

    jpeg_dev = jax.device_put(np.stack(ys))
    idx, dl = pad_scatter(scats)
    proc_ll1 = np.asarray(y_stage1_device(jpeg_dev, idx, dl))

    # host dering (sequential; mutates the LL1 block exactly like the
    # reference's in-place pass)
    marks_list = []
    post = np.empty_like(proc_ll1)
    for i in range(b):
        p512 = np.zeros(4 * SZ, np.int16)
        p512.reshape(N, N)[:D, :D] = proc_ll1[i]
        marks_list.append(dec._dering_mark_y(p512))
        post[i] = p512.reshape(N, N)[:D, :D]

    if any(len(h) for h in hqs):
        hq_idx, hq_dl = pad_scatter(hqs)
    else:  # q <= HIGH1 batch: lets the dense stage fuse to one program
        hq_idx = hq_dl = None
    dp, n_waves, ok = mark_depth_planes(marks_list)
    if ok:
        y_planes = np.asarray(y_stage2_dense_device(
            jpeg_dev, jax.device_put(post), hq_idx, hq_dl,
            jax.device_put(dp), n_waves))
    else:  # out-of-order same-row marks (never observed): exact scan
        if hq_idx is None:
            hq_idx, hq_dl = pad_scatter(hqs)
        recs, valid = pad_marks(marks_list)
        y_planes = np.asarray(y_stage2_device(
            jpeg_dev, jax.device_put(post), hq_idx, hq_dl, recs, valid))

    pre_u = np.asarray(uv_synth_device(jax.device_put(np.stack(us))))
    pre_v = np.asarray(uv_synth_device(jax.device_put(np.stack(vs))))

    # host: UV sharpen (sequential) + clip + upsample, then the exact
    # device colorspace per quality group (decoder/nhw_decoder_cli.c
    # float semantics as a fixed-point replay, ops.colorspace_device)
    from nhwcodec_tpu.ops import colorspace_device as csd

    u_planes = np.empty((b, N, N), np.uint8)
    v_planes = np.empty((b, N, N), np.uint8)
    for i in range(b):
        u_planes[i] = dec.decode_uv_back(pre_u[i].reshape(-1).copy(),
                                         quals[i])
        v_planes[i] = dec.decode_uv_back(pre_v[i].reshape(-1).copy(),
                                         quals[i])

    out: list = [None] * b
    order = sorted(range(b), key=lambda i: quals[i])
    k = 0
    while k < b:
        j = k
        while j < b and quals[order[j]] == quals[order[k]]:
            j += 1
        sel = order[k:j]
        rgb = np.asarray(csd.yuv_to_rgb_device_exact(
            y_planes[sel], u_planes[sel], v_planes[sel],
            quals[sel[0]]))
        for n, i in enumerate(sel):
            out[i] = rgb[n]
        k = j
    return out
