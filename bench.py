"""Benchmark: the full bit-exact NHW codec + its device compute core.

Headline metric: full-codec encode throughput at q20 (byte-exact vs the
reference, BASELINE.md: reference single-core C = 9.1 MP/s).  The
"extra" map reports the rest of the measurement matrix:

- full_decode / q9 encode / single-core encode (host runtime)
- the device transform stages (the bit-exact front = exact colorspace
  + both analysis levels; the f32 transform; the decode back end and
  requant tail) measured with CHAINED data-dependent iterations inside
  one jit: the per-iteration slope excludes dispatch and transfer
- the device-wired full codec (parallel.device_pipeline): byte-identical
  output with the plane transforms on the card

Needs a GPU (it never falls back to the CPU).  Run: ``python bench.py``.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np


def _t_min(fn, x, reps=4):
    np.asarray(fn(x))  # compile + warm
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        np.asarray(fn(x))
        ts.append(time.perf_counter() - t0)
    return min(ts)


def _per_iter(mk, x, n1, n2):
    """True per-iteration device time from the chained-jit slope."""
    return (_t_min(mk(n2), x) - _t_min(mk(n1), x)) / (n2 - n1)


def _chain(fn_scalar):
    import jax
    import jax.numpy as jnp

    def mk(n):
        @jax.jit
        def f(x):
            def body(c, _):
                s = fn_scalar(x + c)
                return (s & 1).astype(jnp.uint8), None
            c, _ = jax.lax.scan(body, jnp.uint8(0), None, length=n)
            return c
        return f

    return mk


def _looped(step, c0):
    """mk(n) for _per_iter over ONE compiled program: n data-dependent
    iterations c -> step(x, c) with a traced trip count, so both slope
    points share a compile (the chain cascade takes ~100 s to compile
    per program on an H100)."""
    import jax

    f = jax.jit(lambda x, n: jax.lax.fori_loop(
        0, n, lambda _, c: step(x, c), c0))
    return lambda n: (lambda x: f(x, n))


def _device_numbers(b: int = 64) -> dict:
    import jax
    import jax.numpy as jnp

    from nhwcodec_tpu.models.device_stages import analysis_uv, analysis_y
    from nhwcodec_tpu.models.transform import (decode_transform,
                                               encode_transform,
                                               rgb_to_yuv420_device)
    from nhwcodec_tpu.ops import colorspace_device as csd

    rng = np.random.default_rng(0)
    mp = b * 512 * 512 / 1e6
    rgb = jax.device_put(rng.integers(0, 256, (b, 512, 512, 3), np.uint8))
    out = {}

    def enc_scalar(inp):
        y, u, v = encode_transform(inp)
        return y.astype(jnp.int32).sum()

    out["device_transform_f32_mp_s"] = mp / _per_iter(
        _chain(enc_scalar), rgb, 2, 26)

    from nhwcodec_tpu.ops import colorspace_limb as cslimb

    def cs_limb_scalar(inp):
        y, u, v = cslimb.yuv_norm_limb(inp[..., 0], inp[..., 1],
                                       inp[..., 2], jnp)
        du = csd._down420(csd._clip_u8(u, jnp).astype(jnp.uint8), jnp)
        dv = csd._down420(csd._clip_u8(v, jnp).astype(jnp.uint8), jnp)
        return (y.astype(jnp.int32).sum() + du.astype(jnp.int32).sum()
                + dv.astype(jnp.int32).sum())

    out["device_exact_colorspace_mp_s"] = mp / _per_iter(
        _chain(cs_limb_scalar), rgb, 2, 10)

    def front_scalar(inp):
        # the deployed q20 front: u32-limb exact colorspace + both
        # bit-exact analysis levels (ops.colorspace_limb, no x64)
        y, u, v = cslimb.yuv_norm_limb(inp[..., 0], inp[..., 1],
                                       inp[..., 2], jnp)
        y = y.astype(jnp.int16)
        u = csd._down420(csd._clip_u8(u, jnp).astype(jnp.uint8), jnp)
        v = csd._down420(csd._clip_u8(v, jnp).astype(jnp.uint8), jnp)
        yj, yp, yr, ys = analysis_y(y)
        uj, up, ur = analysis_uv(u, 20)
        vj, vp, vr = analysis_uv(v, 20)
        return (yp.astype(jnp.int32).sum() + up.astype(jnp.int32).sum()
                + vp.astype(jnp.int32).sum() + yj.astype(jnp.int32).sum())

    out["device_exact_front_mp_s"] = mp / _per_iter(
        _chain(front_scalar), rgb, 2, 10)

    yc = jax.device_put(rng.integers(-64, 64, (b, 512, 512), np.int16))

    def dec_scalar(inp):
        uc = (inp[..., :256, :256] >> 2).astype(jnp.int16)
        return decode_transform(inp, uc, uc).astype(jnp.int32).sum()

    out["device_decode_transform_mp_s"] = mp / _per_iter(
        _chain(dec_scalar), yc, 2, 26)

    # the bit-exact decode synthesis back end (models.device_decode):
    # Y stage1 + stage2 + both UV planes, through the DEPLOYED dense
    # mark-wave path under a heavy realistic dering load (~8k marks per
    # image, the textured-content regime; the dense wave form makes the
    # cost mark-count-insensitive)
    from nhwcodec_tpu.models import device_decode as dd

    idx = jnp.zeros((b, 8), jnp.int32)
    dl = jnp.zeros((b, 8), jnp.int16)
    _marks = []
    for _i in range(b):
        _ms = [(r << 8) | c for r in range(1, 255)
               for c in range(1 + (_i & 1), 255, 8)]
        _marks.append(_ms)
    dpl, n_waves, _ok = dd.mark_depth_planes(_marks)
    assert _ok
    dpl = jax.device_put(dpl)

    def dec_exact_scalar(inp):
        u = inp[:, ::2, ::2].astype(jnp.int16)
        proc = dd.y_stage1_device(inp, idx, dl)
        y = dd.y_stage2_dense_device(inp, proc, idx, dl, dpl, n_waves)
        pu = dd.uv_synth_device(u)
        pv = dd.uv_synth_device((u + 1).astype(jnp.int16))
        return (y.astype(jnp.int32).sum() + pu.astype(jnp.int32).sum()
                + pv.astype(jnp.int32).sum())

    out["device_exact_decode_back_mp_s"] = mp / _per_iter(
        _chain(dec_exact_scalar), yc, 2, 18)

    # the encoder's requant feedback tail (models.device_requant):
    # synthesis + unmark + compare-ladder fixpoint + re-analysis
    from nhwcodec_tpu.models import device_requant as drq

    def requant_scalar(inp):
        proc = (inp >> 1).astype(jnp.int16)
        r = (inp[:, :256, :256] >> 3).astype(jnp.int16)
        j2, p2, rc = drq.requant_tail_device(inp, proc, r)
        return (j2.astype(jnp.int32).sum() + p2.astype(jnp.int32).sum()
                + rc.astype(jnp.int32).sum())

    out["device_requant_tail_mp_s"] = mp / _per_iter(
        _chain(requant_scalar), yc, 2, 14)

    # the prefix-sum bit packer (tokens -> u32 words), Mtokens/s
    from nhwcodec_tpu.ops.entropy_device import (_tokens_to_codes_zone,
                                                 pack_bits_device)

    ntok = 1 << 18
    toks = jax.device_put(
        rng.integers(0, 354, (ntok,)).astype(np.int32))

    def pack_scalar(pos):
        codes, lens = _tokens_to_codes_zone(pos % 354)
        w = pack_bits_device(codes, lens, 80000)
        return w.astype(jnp.int32).sum()

    it = _per_iter(_chain(pack_scalar), toks, 2, 26)
    out["device_pack_mtok_s"] = ntok / it / 1e6

    # device Huffman decode (peek-LUT + pointer-doubling + vmapped
    # automaton), ms/image on a 32-stream batch of real q20 streams
    from nhwcodec_tpu.models import encoder as enc_mod
    from nhwcodec_tpu.ops import entropy_decode_device as edd
    from nhwcodec_tpu.utils import container, fixtures

    sa = container.parse_nhw(enc_mod.encode(fixtures.texture_noise(), 20))
    sb = container.parse_nhw(enc_mod.encode(fixtures.gradient_circles(),
                                            20))
    base = [sa] * 16 + [sb] * 16
    # distinct batch orderings per call: no call repeats the last one's
    # inputs
    batches = [base[i:] + base[:i] for i in range(5)]
    edd.decode_y_device_batch(batches[4])  # compile + warm
    ts = []
    for i in range(4):
        t0 = time.perf_counter()
        edd.decode_y_device_batch(batches[i])
        ts.append(time.perf_counter() - t0)
    out["device_entropy_y_ms_img"] = min(ts) / 32 * 1000

    # non-transfer per-image cost of the same path (chained slope):
    # chain + xs-prep + fixpoint + emit, everything device-resident
    out["device_entropy_y_nontransfer_ms_img"] = _entropy_phase_sum(base)
    return {k: round(v, 1) for k, v in out.items()}


def _entropy_phase_sum(streams) -> float:
    """Sum of the four decode_y device phases measured with chained
    data-dependent iterations (nothing fetched but a scalar)."""
    import jax
    import jax.numpy as jnp

    from nhwcodec_tpu import tables as T
    from nhwcodec_tpu.ops import entropy
    from nhwcodec_tpu.ops import entropy_chain_scan as ecs
    from nhwcodec_tpu.ops import entropy_decode_device as edd

    b = len(streams)
    p1 = 4 * T.IM_SIZE
    all_nbits = [s.packet1.size * 32 for s in streams]
    s_max = 1 << (min(p1, max(64, max(all_nbits) // 2 + 2))
                  - 1).bit_length()
    nw = 1 << max(7, int(max(s.packet1.size for s in streams)
                         ).bit_length())
    wordsB = np.zeros((b, nw), np.uint32)
    for i, s in enumerate(streams):
        wordsB[i, :s.packet1.size] = s.packet1
    nbits = jnp.asarray(all_nbits, dtype=jnp.int32)
    zone = jnp.asarray([1 if s.res_high < 4 else 0 for s in streams],
                       jnp.int32)
    wordsD = jax.device_put(wordsB)

    def chain_step(w, c):
        _, counts = ecs.chain_starts_batch.__wrapped__(w ^ c, nbits, zone,
                                                       s_max)
        return (counts[0] & 1).astype(jnp.uint32)

    total = _per_iter(_looped(chain_step, jnp.uint32(0)), wordsD, 1, 4)

    symB_full, countB = edd._chain_batch_scan(streams, s_max)
    books = [entropy.build_y_book(s.tree1) for s in streams]
    run_refs = [edd._run_count(symB_full[i],
                               edd._book_device(*books[i])[0], countB[i])
                for i in range(b)]
    cr = np.asarray(jnp.stack([countB, jnp.stack(run_refs)]))
    s_trim = min(edd._bucket(int(cr[0].max()) + 1), s_max)
    r_max = edd._bucket(int(max(cr[1].max(), 1)))

    def pad_rows(rows):
        n = 1 << max(6, (max(len(r) for r in rows) - 1).bit_length())
        o = np.zeros((len(rows), n), np.int32)
        for i, r in enumerate(rows):
            o[i, :len(r)] = r
        return jnp.asarray(o)

    symB = jax.device_put(np.asarray(symB_full[:, :s_trim]))
    vB = pad_rows([bk[0] for bk in books])
    rB = pad_rows([bk[1] for bk in books])
    s1B = pad_rows([np.unpackbits(np.ascontiguousarray(
        s.select_word1, np.uint8)) for s in streams])
    s2B = pad_rows([np.unpackbits(np.ascontiguousarray(
        s.select_word2, np.uint8)) for s in streams])
    k = min(64, r_max)

    def xs_step(s, c):
        _, lits = edd._runs_xs_batch(s + c, vB, rB, p1, r_max, k)
        return (lits[1][0, 0] & 1).astype(jnp.int32)

    total += _per_iter(_looped(xs_step, jnp.int32(0)), symB, 1, 4)
    xs_t, lits = edd._runs_xs_batch(symB, vB, rB, p1, r_max, k)
    rest = tuple(xs_t[1:])

    def fix_step(x0, c):
        ys, _it = edd._runs_fixpoint.__wrapped__((x0 + c,) + rest, p1, k)
        return (ys[3][0, 0] & 1).astype(jnp.int32)

    total += _per_iter(_looped(fix_step, jnp.int32(0)), xs_t[0], 1, 4)
    ys, _it = edd._runs_fixpoint(xs_t, p1, k)
    ys_rest = (ys[0], ys[1], ys[2])

    def emit_step(y3, c):
        o = edd._runs_emit_batch.__wrapped__(ys_rest + (y3 + c,), lits, s1B,
                                             s2B, p1, r_max)
        return (o[0, 0] & 1).astype(jnp.int32)

    total += _per_iter(_looped(emit_step, jnp.int32(0)), ys[3], 1, 4)
    return total / b * 1000


def _median(xs):
    xs = sorted(xs)
    n = len(xs)
    return xs[n // 2] if n % 2 else 0.5 * (xs[n // 2 - 1] + xs[n // 2])


class _pin_one_core:
    """Pin the current process to one core for single-core rows: the
    scheduler bouncing the thread between cores adds noise on a shared
    machine."""

    def __enter__(self):
        try:
            self.saved = os.sched_getaffinity(0)
            os.sched_setaffinity(0, {min(self.saved)})
        except (AttributeError, OSError):
            self.saved = None
        return self

    def __exit__(self, *exc):
        if self.saved is not None:
            os.sched_setaffinity(0, self.saved)


def _reference_numbers(imgs: np.ndarray) -> dict:
    """Interleaved same-session re-measure of the reference C encoder
    (single core, incl. process spawn + file IO, exactly like
    BASELINE.md's methodology) so the artifact of record carries a
    same-conditions denominator alongside the fixed 9.1 baseline."""
    import subprocess
    import sys
    import tempfile
    from pathlib import Path

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "tools"))
    try:
        import oracle

        if not oracle.available():
            return {}
        enc, _ = oracle.build()
    except Exception:  # noqa: BLE001 — reference sources absent
        return {}

    from nhwcodec_tpu.utils import bmp

    out = {}
    with tempfile.TemporaryDirectory() as td:
        paths = []
        for i in range(8):
            p = Path(td) / f"{i}.bmp"
            bmp.write_bmp512(p, imgs[i])
            paths.append(p)
        with _pin_one_core():
            for q, key in ((20, "ref_encode_mp_s"),
                           (9, "ref_encode_q9_mp_s")):
                ts = []
                for _ in range(3):
                    t0 = time.perf_counter()
                    for p in paths:
                        subprocess.run(
                            [str(enc), f"-q{q}", "-f", str(p),
                             str(Path(td) / "o.nhw")],
                            check=True, capture_output=True)
                    ts.append(8 * 0.262144 / (time.perf_counter() - t0))
                out[key] = round(_median(ts), 3)
    return out


def _scans_share_and_pack(imgs: np.ndarray) -> dict:
    """The host's per-image cost with the transforms precomputed (the
    ceiling the host puts on the device-front encode — E4 + the raster
    scans + the tokenizer, 4 threads, C scans release the GIL), and
    host-pack vs device-pack times on identical streams."""
    from concurrent.futures import ThreadPoolExecutor

    from nhwcodec_tpu.models import encoder as enc
    from nhwcodec_tpu.ops import analysis, colorspace, entropy_enc
    from nhwcodec_tpu.ops import prefilter, requant

    q = 20
    states = []
    for im in imgs:
        y, u, v = colorspace.downsample_yuv420(im, q)
        y_orig = y
        y1 = prefilter.pre_process_y(y, q)
        jpeg = y1.astype(np.int16).copy()
        process = np.zeros((512, 512), np.int16)
        snap = analysis.wavelet_analysis(jpeg, process, 512, 0, 0,
                                         snapshot=False)
        res256 = jpeg[:256, :256].copy()
        analysis.wavelet_analysis(jpeg, process, 256, 1, 0)
        requant.mark_res256(process, res256)
        requant.offset_y_recons256(jpeg, process, q, 8, part=1)
        analysis.wavelet_synthesis(jpeg, process, 256, 0)
        requant.unmark_res256(process, res256)
        requant.requant_scan_ladder(jpeg, process, res256)
        analysis.wavelet_analysis(jpeg, process, 256, 1, 0)
        pre_y = (jpeg, process, res256, None)

        def uv_pre(plane):
            j2 = plane.astype(np.int16).copy()
            p2 = np.zeros((256, 256), np.int16)
            analysis.wavelet_analysis(j2, p2, 256, 0, 0)
            r2 = j2[:128, :128].copy()
            analysis.wavelet_analysis(j2, p2, 128, 1, 0)
            return (j2, p2, r2)

        states.append((y1, y_orig, u, v, pre_y, uv_pre(u), uv_pre(v)))

    def one(st):
        y1, y_orig, u, v, pre_y, pre_u, pre_v = st
        # E4 on a fresh buffer (the identity caches must miss)
        prefilter.pre_process_y(np.array(y_orig), q)
        py = tuple(np.array(a) if a is not None else None for a in pre_y)
        pu = tuple(np.array(a) for a in pre_u)
        pv = tuple(np.array(a) for a in pre_v)
        return enc.encode_from_planes(
            np.array(y1), u, v, q, y_original=y_orig, pre_y=py,
            pre_u=pu, pre_v=pv, requant_done=True, defer_pack=True)

    n = len(states)
    with ThreadPoolExecutor(max_workers=4) as ex:
        list(ex.map(one, states))  # warm
        ts = []
        for _ in range(4):
            t0 = time.perf_counter()
            deferred = list(ex.map(one, states))
            ts.append(time.perf_counter() - t0)
    out = {"host_scans_share_mp_s_4w":
           round(n * 0.262144 / _median(ts), 2)}

    # host pack vs device pack on identical real streams (item 4b):
    # rebuild one real im_nhw, then time the host packer minus its
    # tokenizer share vs the batched device prefix-sum pack
    st = states[1]  # texture image: the densest token stream
    y1, y_orig, u, v, pre_y, pre_u, pre_v = st
    im_nhw, sec = enc.encode_y(
        np.array(y1), q, 8, y_original=y_orig,
        pre=tuple(np.array(a) if a is not None else None
                  for a in pre_y), requant_done=True)
    uf = np.ascontiguousarray(u, np.uint8).reshape(-1)
    oob_u = int(np.uint16(int(uf[32768])
                          | (int(uf[32769]) << 8)).view(np.int16))
    tail = np.array(
        [np.uint16(int(uf[32768 + 2 * i])
                   | (int(uf[32769 + 2 * i]) << 8)).view(np.int16)
         for i in range(4)], np.int16)
    pu2, _, _ = enc.encode_uv(u, q, 0, 8, oob0=oob_u, oob_tail=tail,
                              pre=tuple(np.array(a) for a in pre_u))
    from nhwcodec_tpu.ops import quantize
    quantize.serpentine_uv(im_nhw, pu2, 0)
    pv2, _, _ = enc.encode_uv(v, q, 1, 8, oob0=oob_u, oob_tail=tail,
                              pre=tuple(np.array(a) for a in pre_v))
    quantize.serpentine_uv(im_nhw, pv2, 1)

    def med(fn, reps=5):
        fn()
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
        return _median(ts)

    # three comparable components: the all-host C packer path, the
    # host tokenizer alone (shared by both paths), and the batched
    # device pack amortized over 32 streams — the device path per image
    # is tokenize + pack_b32 (the 'device >= host at batch >= 32' claim
    # is host_pack_path vs tokenize + device_pack_only)
    t_full = med(lambda: entropy_enc.wavlts2packet(
        im_nhw, sec["nhw_select1"], sec["nhw_select2"],
        device_pack=False))
    t_tok = med(lambda: entropy_enc.wavlts2packet_tokenize(im_nhw))
    tps = [entropy_enc.wavlts2packet_tokenize(im_nhw) for _ in range(32)]
    t_dev = med(lambda: entropy_enc.pack_tokenized_batch(
        [entropy_enc.wavlts2packet_tokenize(im_nhw)] + tps[1:]), reps=3)
    out["host_pack_path_ms_img"] = round(t_full * 1000, 2)
    out["tokenize_ms_img"] = round(t_tok * 1000, 2)
    out["device_pack_only_b32_ms_img"] = round(
        (t_dev - t_tok) / 32 * 1000, 3)
    return out


def _host_numbers() -> dict:
    from nhwcodec_tpu.parallel import api, device_pipeline
    from nhwcodec_tpu.utils import fixtures

    imgs = np.stack([fixtures.gradient_circles(), fixtures.texture_noise(),
                     fixtures.sharp_blocks(), fixtures.near_flat()] * 12)
    ncore = os.cpu_count() or 1
    out = {}

    def median_of(fn, n=5):
        """Median MP/s over n reps (medians, not best-of); returns
        (median, last streams)."""
        vals = []
        streams = None
        for _ in range(n):
            st, m = fn()
            vals.append(m.mp_per_s)
            if streams is None:
                streams = st
        return _median(vals), streams

    # warm the persistent spawn pool, then median-of-N
    api.encode_batch(imgs[: 4 * ncore], 20)
    menc, streams = median_of(lambda: api.encode_batch(imgs, 20), n=5)
    out["full_encode_mp_s"] = round(menc, 3)

    mq9, _ = median_of(lambda: api.encode_batch(imgs[:16], 9), n=4)
    out["full_encode_q9_mp_s"] = round(mq9, 3)

    with _pin_one_core():
        m1, _ = median_of(
            lambda: api.encode_batch(imgs[:8], 20, workers=0), n=4)
        out["single_core_encode_mp_s"] = round(m1, 3)
        m1q9, _ = median_of(
            lambda: api.encode_batch(imgs[:8], 9, workers=0), n=3)
        out["single_core_encode_q9_mp_s"] = round(m1q9, 3)

    out.update(_reference_numbers(imgs))

    good = [s for s in streams if s is not None]
    mdec, _ = median_of(lambda: api.decode_batch(good), n=5)
    out["full_decode_mp_s"] = round(mdec, 3)

    with _pin_one_core():
        m1d, _ = median_of(
            lambda: api.decode_batch(good[:8], workers=0), n=4)
        out["single_core_decode_mp_s"] = round(m1d, 3)

    # the pool gap: measured pool throughput vs
    # cores x single-core
    out["pool_efficiency"] = round(
        menc / (ncore * out["single_core_encode_mp_s"]), 3)

    out.update(_scans_share_and_pack(imgs[:8]))

    # device-wired full codec (byte-identical output, transforms on the
    # card)
    device_pipeline.encode_batch_device(imgs[:8], 20)
    mdev, _ = median_of(
        lambda: device_pipeline.encode_batch_device(imgs[:16], 20), n=3)
    out["full_encode_device_wired_mp_s"] = round(mdev, 3)

    device_pipeline.decode_batch_device(good[:8])
    mddec, _ = median_of(
        lambda: device_pipeline.decode_batch_device(good[:16]), n=3)
    out["full_decode_device_wired_mp_s"] = round(mddec, 3)

    # the full-device encode configuration (every raster scan as
    # batched device programs; byte-identical)
    device_pipeline.encode_batch_device(imgs[:8], 20,
                                        scans_on_device=True)
    ts = []
    for _ in range(2):
        t0 = time.perf_counter()
        device_pipeline.encode_batch_device(imgs[:8], 20,
                                            scans_on_device=True)
        ts.append(time.perf_counter() - t0)
    out["full_encode_scans_device_ms_img"] = round(
        min(ts) / 8 * 1000, 1)
    return out


def main() -> None:
    import jax

    from nhwcodec_tpu.utils.card import name_and_power_limit, require_gpu
    from nhwcodec_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    dev0 = require_gpu()
    card = name_and_power_limit()
    print(card)
    host = _host_numbers()
    dev = _device_numbers()

    baseline = 9.1  # reference C encode MP/s at q20 (BASELINE.md)
    value = host["full_encode_mp_s"]
    extra = {**host, **dev,
             "batch": 48, "cores": os.cpu_count(),
             "device": {"platform": dev0.platform,
                        "kind": dev0.device_kind,
                        "count": len(jax.devices())},
             "card": card}
    extra.pop("full_encode_mp_s")
    print(json.dumps({
        "metric": "full_encode_mp_s",
        "value": value,
        "unit": "MP/s",
        "vs_baseline": round(value / baseline, 2),
        "extra": extra,
    }))


if __name__ == "__main__":
    main()
