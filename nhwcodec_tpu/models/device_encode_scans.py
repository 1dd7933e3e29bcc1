"""The full-device encode configuration.

``encode_batch_scans_device(images, quality)`` runs every
post-transform raster scan of the encoder on the device as batched XLA
programs (models.device_scans): the E11 cleanup ladders and snap
passes, the E12 column ladder / classify / positional streams, the E14
quantizers, the E15 serpentine + stream fixups, and the E16/E17 LL2
run-delta compressors — symmetric to decode's ``entropy_on_device``.
The host keeps the E4 pre-filter, the E10 greedy mark/offset passes
(with their transforms), the E18 tokenizer, and the container writer.
Output is byte-identical to ``models.encoder.encode``
(tests/test_device_scans.py).

Stage-major batching: each host stage runs per image, each device
stage runs once for the whole batch.  Quality support: 1 <= q <=
T.HIGH1 — the full low-q family included (the duty-cycle quantizer,
the very-low-q window ladders, the count-adaptive lowest-q band
cleanup with its heap-alias r3 tail, and the UV laplacian nudge /
band zeroing / LL smooth).  Only the q>HIGH1 HQ residue still routes
to the host encoder.
"""

from __future__ import annotations

import numpy as np

from nhwcodec_tpu import tables as T
from nhwcodec_tpu.models import device_scans as ds
from nhwcodec_tpu.models import encoder as enc
from nhwcodec_tpu.ops import analysis, colorspace, requant

D = 256
N = 512
SZ = 65536


def supported(quality: int) -> bool:
    # full coverage up to HIGH1; the q>HIGH1 HQ residue stays
    # host-routed
    return 1 <= quality <= T.HIGH1


def _stack(arrs, dtype=np.int16):
    return np.ascontiguousarray(np.stack(arrs).astype(dtype))


def encode_batch_scans_device(images: np.ndarray, quality: int = 20
                              ) -> list[bytes]:
    """(B,512,512,3) uint8 -> list of .nhw byte strings, byte-identical
    to the host encoder, with every raster scan on the device."""
    from nhwcodec_tpu.ops import entropy_enc, prefilter

    q = quality
    if not supported(q):
        raise ValueError(f"scans_on_device supports 1<=q<=HIGH1, got {q}")
    ratio = 8
    b = len(images)

    # ---- host front: colorspace + prefilter + transforms + requant ----
    ys, us, vs, yorigs = [], [], [], []
    for im in images:
        y, u, v = colorspace.downsample_yuv420(im, q)
        yorigs.append(y)
        if q < T.HIGH2:
            y = prefilter.pre_process_y(y, q)
        ys.append(y)
        us.append(u)
        vs.append(v)

    jpegs, procs, res256s = [], [], []
    for k in range(b):
        jpeg = ys[k].astype(np.int16).copy()
        process = np.zeros((N, N), np.int16)
        analysis.wavelet_analysis(jpeg, process, N, 0, 0, snapshot=False)
        res256 = jpeg[:D, :D].copy()
        analysis.wavelet_analysis(jpeg, process, D, 1, 0)
        if q > T.LOW14:
            requant.mark_res256(process, res256)
            requant.offset_y_recons256(jpeg, process, q, ratio, part=1)
            analysis.wavelet_synthesis(jpeg, process, D, 0)
            requant.unmark_res256(process, res256)
            requant.requant_scan_ladder(jpeg, process, res256)
            analysis.wavelet_analysis(jpeg, process, D, 1, 0)
        jpegs.append(jpeg)
        procs.append(process)
        res256s.append(res256)

    sections = [dict() for _ in range(b)]

    # ---- device: low-q cleanup ladders (before the LL2 coding) ----
    P = _stack(procs)
    if q <= T.LOW9:
        P = np.asarray(ds.low_q_ll1_cleanup_device(
            P, 10 if q > T.LOW14 else 11))
    if q < T.LOW7:
        P = np.asarray(ds.very_low_q_cleanup_device(
            P, q, enc._VLQ_THRX(q, None)))
    if q <= T.LOW9 or q < T.LOW7:
        for k in range(b):
            procs[k][:] = P[k]

    resIII = P[:, :D, :D].copy()

    # ---- device: LL2 coding + Y highres (E16) ----
    Pd, tree1B, chresB, exwB, nexwB, res4B, nres4B = \
        ds.ll2_code_y_device(P, q > T.LOW3)
    tree1B = np.asarray(tree1B)
    chresB = np.asarray(chresB)
    exwB = np.asarray(exwB)
    nexw = np.asarray(nexwB)
    res4B = np.asarray(res4B)
    nres4 = np.asarray(nres4B)
    for k in range(b):
        sections[k]["exw_Y"] = exwB[k, : nexw[k]].reshape(-1).tolist()
        if q > T.LOW3:
            sections[k]["res4"] = res4B[k, : nres4[k]].astype(np.uint8)

    h = np.zeros((b, 16384 + 8193 + 64), np.int32)
    h[:, :16384] = tree1B
    hrB, nhrB, rlB, hwB, nhwB, hmB, nhmB = ds.y_highres_device(
        h, chresB.astype(np.int32), q > T.LOW5)
    hrB = np.asarray(hrB)
    nhr = np.asarray(nhrB)
    rl = np.asarray(rlB)
    hwB = np.asarray(hwB)
    nhw = np.asarray(nhwB)
    hmB = np.asarray(hmB)
    nhm = np.asarray(nhmB)
    for k in range(b):
        sections[k]["res_low"] = int(rl[k])
        sections[k]["highres_word"] = hwB[k, : nhw[k]].astype(np.uint8)
        sections[k]["hrcomp_y"] = hrB[k, : nhr[k]].tolist()
        sections[k]["tree1_y"] = tree1B[k]

    # ---- host: E10 part-0 offset + synthesis (greedy raster) ----
    P = np.asarray(Pd)
    for k in range(b):
        procs[k][:] = P[k]
        procs[k][:D, :D] = resIII[k]
        if q > T.LOW8:
            ht_out: list = []
            requant.offset_y_recons256(
                jpegs[k], procs[k], q, ratio, part=0,
                highres_mem=np.array(hmB[k, : nhm[k]], np.int64),
                highres_tmp_out=ht_out)
            analysis.wavelet_synthesis(jpegs[k], procs[k], D, 0)

    # ---- device: cleanup ladders + pair promotion (E11) ----
    P = _stack(procs)
    if T.LOW5 < q < T.NORM:
        P = np.asarray(ds.mid_q_band_cleanup_device(P))
    elif T.LOW6 <= q <= T.LOW5:
        P = np.asarray(ds.low56_band_cleanup_device(
            P, 19 if q == T.LOW5 else 20))
    elif q < T.LOW6:
        # the host builds the r3 tail from the free-time kernel state +
        # the tree1 chunk bytes (heap-alias model, models/encoder.py)
        oobs = np.zeros((b, 256), np.int16)
        for k in range(b):
            kern = prefilter.final_low_kernel(yorigs[k], q)
            oobs[k, 0:4] = np.asarray(kern).reshape(-1)[131080:131084]
            oobs[k, 4] = 24593
            t = tree1B[k, :496].astype(np.uint16)
            oobs[k, 8:8 + 248] = (t[0::2] | (t[1::2] << 8)
                                  ).astype(np.uint16).view(np.int16)
        r3_ext = np.concatenate(
            [resIII.reshape(b, -1), oobs], axis=1)
        # thresholds are count-adaptive PER IMAGE and static to the
        # device program: group the batch by tuple
        xs_all = [enc._lowest_q_xs(P[k].reshape(-1), q)
                  for k in range(b)]
        groups: dict = {}
        for k, xs5 in enumerate(xs_all):
            groups.setdefault(xs5, []).append(k)
        for xs5, idxs in groups.items():
            P[idxs] = np.asarray(ds.lowest_q_band_cleanup_device(
                P[idxs], r3_ext[idxs], q, xs5))
    if q > T.LOW4:
        P = np.asarray(ds.pair_promotion_device(P))

    # ---- device: column ladder + classify + streams (E12) ----
    res_setting = enc._res_setting(q)
    if q > T.LOW8:
        kheads = []
        for k in range(b):
            kern = (prefilter.final_low_kernel(yorigs[k], q)
                    if q <= T.LOW4 else prefilter.kernel_for(yorigs[k], q))
            kheads.append(np.asarray(kern).reshape(-1)[65536:65540]
                          .astype(np.int16))
        rf_ext = np.zeros((b, SZ + 1024), np.int16)
        for k in range(b):
            rf_ext[k, :SZ] = res256s[k].reshape(-1)
            rf_ext[k, SZ: SZ + 4] = kheads[k][:4]
            rf_ext[k, SZ + 4: SZ + 8] = [17, 2, 0, 0]
            rf_ext[k, SZ + 8:] = resIII[k].reshape(-1)[:1016]
        Pj, rfB = ds.column_ladder_device(P, rf_ext, q, res_setting)
        Pj, rfB, n1B, n3B, n5B = ds.classify_device(
            Pj, np.asarray(rfB).reshape(b, D, D), q, res_setting)
        P = np.array(Pj)
        rf = np.asarray(rfB)

        def _streams(codes, word_bits, key):
            wt = np.full(256, -1, np.int32)
            rt = np.zeros(256, np.int32)
            for c, (w, r) in codes.items():
                wt[c] = w
                rt[c] = r
            nonlocal rf
            rfB2, pk, npk, bit, nnm, wrd, nw = \
                ds.positional_stream_device(rf, wt, rt, word_bits)
            rf = np.asarray(rfB2)
            pk = np.asarray(pk)
            bit = np.asarray(bit)
            wrd = np.asarray(wrd)
            npk = np.asarray(npk)
            nnm = np.asarray(nnm)
            nw = np.asarray(nw)
            for k in range(b):
                bl = (int(nnm[k]) >> 3) + 1
                sections[k][key] = pk[k, : npk[k]].astype(np.uint8)
                sections[k][key + "_bit"] = bit[k, :bl].astype(np.uint8)
                wl = ((int(nw[k]) >> 3) + 1 if word_bits == 1
                      else 2 * ((int(nw[k]) >> 3) + 1))
                sections[k][key + "_word"] = wrd[k, :wl].astype(np.uint8)

        _streams({141: (1, 0), 140: (0, 0), 126: (0, 122),
                  125: (1, 121), 148: (1, 144), 149: (0, 145)}, 1, "res1")
        if q >= T.LOW1:
            _streams({121: (1, 0), 122: (0, 0), 123: (2, 0),
                      124: (3, 0)}, 2, "res3")
        if q >= T.HIGH1:
            _streams({144: (1, 0), 145: (0, 0)}, 1, "res5")

    # ---- device: LL2-zone rebuild + snap passes (E11) + offset (E14) ----
    block = resIII.copy()
    zone = block[:, :128, :128]
    zone[zone <= 8000] = 0
    P[:, :D, :D] = block
    Pd = P
    if q > T.HIGH2:
        yw, yw2 = 8, 4
    else:
        yw, yw2 = 9, 9
    Pd = ds.snap_pass_device(Pd, 1, 255, D + 1, 2 * D - 1, ratio - 2,
                             yw, yw2, False, True, 2 * D - 2)
    if q > T.HIGH2:
        yw, yw2 = 8, 4
    elif q > T.LOW3:
        yw, yw2 = 8, 9
    else:
        yw, yw2 = 9, 9
    Pd = ds.snap_pass_device(Pd, D, 511, 1, D, ratio - 2, yw, yw2,
                             True, False, D - 2)
    yw = 8 if q > T.HIGH2 else 11
    Pd = ds.snap_pass_device(Pd, D, 511, D + 1, 2 * D - 1, ratio - 1,
                             yw, yw, False, False, 2 * D - 2)
    if q > T.LOW4:
        Pd = ds.offset_y_device(Pd, ratio)
    else:
        Pd = ds.offset_y_low4_device(Pd, ratio)

    # ---- device: serpentine + merge + select + cap (E15) ----
    serp = np.asarray(ds.serpentine_y_device(Pd))
    stream = np.zeros((b, 6 * SZ + 16), np.uint8)
    stream[:, : 4 * SZ] = serp
    stream = np.asarray(ds.merge_crossing_device(stream))
    stream, sel1B, sel2B = ds.select_codes_device(np.asarray(stream))
    stream = np.array(ds.cap_long_runs_device(np.asarray(stream)))
    sel1 = np.asarray(sel1B)
    sel2 = np.asarray(sel2B)

    # ---- UV pipeline (host greedy parts + device scans) ----
    uf = [np.ascontiguousarray(u, np.uint8).reshape(-1) for u in us]
    oob_u = np.array([int(np.uint16(int(f[32768]) | (int(f[32769]) << 8)
                                    ).view(np.int16)) for f in uf])

    def _u8_pairs(f, off, kk=4):
        return np.array(
            [np.uint16(int(f[off + 2 * i])
                       | (int(f[off + 2 * i + 1]) << 8)).view(np.int16)
             for i in range(kk)], np.int16)

    tails_u = [_u8_pairs(f, 32768) for f in uf]
    tails_v = tails_u
    oob_v = oob_u

    t1uv = np.zeros((b, 2, 4096), np.uint8)
    exw_uv = [[[], []] for _ in range(b)]
    for comp in (0, 1):
        planes = us if comp == 0 else vs
        oob0 = oob_u if comp == 0 else oob_v
        tails = tails_u if comp == 0 else tails_v
        jms, pms, r256m = [], [], []
        for k in range(b):
            jpeg = planes[k].astype(np.int16).copy()
            process = np.zeros((D, D), np.int16)
            if q <= T.LOW6:
                process[:] = jpeg  # pre_processing_UV copies then nudges
                enc._pre_processing_uv(jpeg, q)
            analysis.wavelet_analysis(jpeg, process, D, 0, 0)
            r256 = jpeg[:128, :128].copy()
            if q <= T.LOW4:
                # per-band |v|-window zeroing (models/encoder.encode_uv)
                for rs, cs, hi in ((slice(0, 128), slice(128, 256), 24),
                                   (slice(128, 256), slice(0, 128), 32),
                                   (slice(128, 256), slice(128, 256), 48)):
                    blk = process[rs, cs]
                    v = np.abs(blk.astype(np.int32))
                    blk[(v >= ratio) & (v < hi)] = 0
            analysis.wavelet_analysis(jpeg, process, 128, 1, 0)
            requant.offset_uv_recons256(jpeg, process, q, ratio, comp=1)
            analysis.wavelet_synthesis(jpeg, process, 128, 0)
            jms.append(jpeg)
            pms.append(process)
            r256m.append(r256)
        J = _stack(jms)
        Pm = _stack(pms)
        R = _stack(r256m)
        J = np.asarray(ds.uv_compare_ladder_device(
            J, Pm, R, oob0, comp == 1))
        resIIIu = []
        for k in range(b):
            jms[k][:] = J[k]
            analysis.wavelet_analysis(jms[k], pms[k], 128, 1, 0)
            resIIIu.append(pms[k][:128, :128].copy())
            requant.offset_uv_recons256(jms[k], pms[k], q, ratio, comp=0)
            analysis.wavelet_synthesis(jms[k], pms[k], 128, 0)
        Pm = _stack(pms)
        if q >= T.LOW2:
            res_uv = 4 if q > T.LOW3 else 5
            rf_ext = np.zeros((b, 16384 + 512), np.int16)
            for k in range(b):
                rf_ext[k, :16384] = r256m[k].reshape(-1)
                rf_ext[k, 16384: 16384 + 4] = tails[k][:4]
            Pm = np.array(ds.uv_sentinel_marking_device(
                Pm, rf_ext, res_uv))
        for k in range(b):
            Pm[k, :128, :128] = resIIIu[k]
        if q <= T.LOW9:
            Pm = np.asarray(ds.uv_ll_smooth_device(Pm))
        Pm2, t1B, exwB2, nexB = ds.ll2_code_uv_device(Pm)
        t1uv[:, comp] = np.asarray(t1B)
        exwB2 = np.asarray(exwB2)
        nexB = np.asarray(nexB)
        for k in range(b):
            exw_uv[k][comp] = exwB2[k, : nexB[k]].reshape(-1).tolist()
        PmQ = np.asarray(ds.offset_uv_device(np.asarray(Pm2), ratio))
        su = np.asarray(ds.serpentine_uv_device(PmQ))
        stream[:, 4 * SZ + comp: 6 * SZ + comp - 1: 2] = su

    # ---- device: UV highres (E17) + host assembly ----
    tree_uv = (np.concatenate([t1uv[:, 0], t1uv[:, 1]], axis=1)
               & 252).astype(np.int32)
    huv = np.zeros((b, 8192 + 80), np.int32)
    huv[:, :8192] = tree_uv
    uvhB, nuvB = ds.uv_highres_device(huv)
    uvh = np.asarray(uvhB)
    nuv = np.asarray(nuvB)

    out: list[bytes] = []
    deferred = []
    for k in range(b):
        sec = sections[k]
        sec["exw_Y"] = (sec["exw_Y"] + [0, 0] + exw_uv[k][0]
                        + [0, 0] + exw_uv[k][1])
        if q > T.LOW5:
            sec["res_U_64"] = np.packbits((t1uv[k, 0] >> 1) & 1)
            sec["res_V_64"] = np.packbits((t1uv[k, 1] >> 1) & 1)
        sec["ch_res"] = np.array(
            sec.pop("hrcomp_y") + uvh[k, : nuv[k]].tolist(), np.uint8)
        sec["nhw_select1"] = int(sel1[k])
        sec["nhw_select2"] = int(sel2[k])
        deferred.append(enc.DeferredEncode(
            q, sec, entropy_enc.wavlts2packet_tokenize(
                stream[k, : 6 * SZ])))
    return enc.finish_deferred(deferred)
