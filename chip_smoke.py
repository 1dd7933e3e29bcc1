"""Smoke run of the codec's byte-exact device pipelines on a GPU card.

Drives the main path once through the entry points a user calls
(``parallel.device_pipeline.encode_batch_device`` and
``decode_batch_device``) at a real deployment size: a batch of 64
distinct, seeded 512x512 RGB images at q20, the reference's own format
(BASELINE.json config 3, batched 64-image encode on one card).  Every
output is held to the host codec (``models.encoder.encode`` and
``models.decoder.decode``), the plain reference, which shares no device
code:

  0  environment: a GPU is required; card, cores, chunk size, compile
     cache and native host runtime are printed
  1  encode q20, batch 64                          == host encode
  2  encode q23 and q9, 8 images each              == host encode
  3  scans_on_device at q20 and q9, 4 images each  == host encode
  4  decode every stream of 1 and 2 as one mixed-quality list, with the
     host and with the device Huffman decode      == host decode
  5  exact colorspace over all 2^24 RGB / YUV triples (64 planes of
     512x512), encode and decode direction, q20 and q9 == host path

``--cards 4`` runs only the four-card path instead: the data-parallel
``parallel.mesh.encode_batch_sharded`` over a 1-D mesh of four cards,
256 images at q20 and q23 == host encode, their decode through
``decode_batch_device`` == host decode, and the sharded decode back end
and requant tail == the one-card run.

A failed check raises: the exit code is non-zero and the last line
never says ok.  On success the last line is one JSON object,
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.

Run from the repository root:  python chip_smoke.py [--seed N] [--cards 4]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

BATCH = 64


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def make_images(seed: int, n: int) -> np.ndarray:
    """n distinct 512x512 RGB images: gradient_circles and the seven
    extreme generators, then texture_noise / sharp_blocks / near_flat /
    photo_waves with seeds taken from ``seed``; shuffled by ``seed``."""
    from nhwcodec_tpu.utils import fixtures as F

    imgs = [F.gradient_circles()] + [g() for g in
                                     F.EXTREME_GENERATORS.values()]
    seeded = (F.texture_noise, F.sharp_blocks, F.near_flat, F.photo_waves)
    k = 0
    while len(imgs) < n:
        imgs.append(seeded[k % 4](seed * 100_003 + k // 4 + 1))
        k += 1
    order = np.random.default_rng(seed).permutation(len(imgs))[:n]
    out = np.stack([imgs[i] for i in order])
    require(len({im.tobytes() for im in out}) == n, "inputs not distinct")
    return out


def host_encode(imgs: np.ndarray, q: int) -> list[bytes]:
    """models.encoder.encode of every image, on the host process pool
    (its workers stay on JAX's CPU backend)."""
    from nhwcodec_tpu.parallel import api

    out, m = api.encode_batch(imgs, q)
    require(m.failures == 0, f"host encode q{q}: {m.failures} failures")
    return out


def host_decode(streams: list[bytes]) -> list[np.ndarray]:
    """models.decoder.decode of every stream, on the host process pool."""
    from nhwcodec_tpu.parallel import api

    out, m = api.decode_batch(streams)
    require(m.failures == 0, f"host decode: {m.failures} failures")
    return out


def card_processes() -> str:
    """The processes holding a card, as nvidia-smi lists them."""
    import subprocess

    try:
        r = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,name,"
                            "used_memory", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=60)
    except OSError as e:  # informational only
        return f"(nvidia-smi: {e})"
    return r.stdout.strip() or "(none listed)"


def check_streams(label: str, streams, failures: int, want) -> None:
    require(failures == 0, f"{label}: {failures} images failed on the "
                           f"device path")
    bad = [i for i, (g, w) in enumerate(zip(streams, want))
           if g is None or g != w]
    require(len(streams) == len(want) and not bad,
            f"{label}: streams differ from host encode at {bad[:8]}")


def phase_env(batch: int = BATCH):
    """Phase 0.  Returns JAX's default device (a GPU, or SystemExit)."""
    import jax

    from nhwcodec_tpu import native
    from nhwcodec_tpu.parallel import device_pipeline
    from nhwcodec_tpu.utils.card import name_and_power_limit, require_gpu
    from nhwcodec_tpu.utils.compile_cache import enable_compile_cache

    dev = require_gpu()
    log(f"jax {jax.__version__}  device_kind {dev.device_kind}  "
        f"devices {len(jax.devices())}")
    log(name_and_power_limit())
    log(f"cpu_count {os.cpu_count()}  encode_batch_device chunk "
        f"{device_pipeline.default_chunk(batch)} at batch {batch}")
    log(f"compile cache {enable_compile_cache()}")
    ok = native.available()
    log(f"native host runtime loaded: {ok}")
    require(ok, "native host runtime did not load")
    return dev


def phase_encode(imgs: np.ndarray, q: int, label: str = "encode",
                 timed: bool = False) -> list[bytes]:
    """Phases 1 and 2: the default device encode path == host encode."""
    from nhwcodec_tpu.parallel import device_pipeline

    t0 = time.perf_counter()
    streams, m = device_pipeline.encode_batch_device(imgs, q)
    t1 = time.perf_counter() - t0
    check_streams(f"{label} q{q}", streams, m.failures, host_encode(imgs, q))
    msg = f"{label} q{q} batch {len(imgs)}: byte-equal"
    if timed:
        t0 = time.perf_counter()
        again, m2 = device_pipeline.encode_batch_device(imgs, q)
        t2 = time.perf_counter() - t0
        check_streams(f"{label} q{q} (second call)", again, m2.failures,
                      streams)
        msg += (f"; first call {t1:.3f} s (compile included), second "
                f"call {t2:.3f} s")
    log(msg)
    return streams


def phase_scans(imgs: np.ndarray, q: int) -> None:
    """Phase 3: the full-device scans configuration == host encode."""
    from nhwcodec_tpu.parallel import device_pipeline

    t0 = time.perf_counter()
    streams, m = device_pipeline.encode_batch_device(
        imgs, q, scans_on_device=True)
    dt = time.perf_counter() - t0
    check_streams(f"scans_on_device q{q}", streams, m.failures,
                  host_encode(imgs, q))
    log(f"scans_on_device q{q} batch {len(imgs)}: byte-equal, "
        f"{dt:.3f} s (compile included)")


def phase_decode(streams: list[bytes]) -> None:
    """Phase 4: device decode, host and device Huffman == host decode."""
    from nhwcodec_tpu.parallel import device_pipeline

    want = host_decode(streams)
    for on_device in (False, True):
        t0 = time.perf_counter()
        got, m = device_pipeline.decode_batch_device(
            streams, entropy_on_device=on_device)
        dt = time.perf_counter() - t0
        label = f"decode entropy_on_device={on_device}"
        require(m.failures == 0, f"{label}: {m.failures} failures")
        bad = [i for i, (g, w) in enumerate(zip(got, want))
               if g is None or not np.array_equal(g, w)]
        require(not bad, f"{label}: RGB differs from host decode at "
                         f"{bad[:8]}")
        log(f"{label} {len(streams)} streams: pixel-equal, {dt:.3f} s")


def all_triples() -> np.ndarray:
    """Every 24-bit triple exactly once, as 64 planes of 512x512x3."""
    i = np.arange(1 << 24, dtype=np.uint32)
    t = np.stack([i >> 16, (i >> 8) & 255, i & 255], axis=-1)
    return t.astype(np.uint8).reshape(64, 512, 512, 3)


def phase_colorspace(planes: np.ndarray, q: int) -> None:
    """Phase 5: the exact device colorspace, both directions, equals the
    host path on every triple.  Zero tolerance: both directions are
    integer and fixed-point replays (x64 or u32 limbs) of the
    reference's float chains.  The encode direction is held to the
    numpy replay of the same program (``rgb_to_yuv420_host_exact``) and
    to the host codec's own colorspace stage
    (``ops.colorspace.downsample_yuv420``, native C), which shares no
    code with it; the decode direction to ``models.decoder.yuv_to_rgb``."""
    from nhwcodec_tpu.models.decoder import yuv_to_rgb
    from nhwcodec_tpu.ops import colorspace_device as csd
    from nhwcodec_tpu.ops.colorspace import downsample_yuv420

    step = 8
    dev = [np.asarray(a) for a in csd.rgb_to_yuv420_device_exact(planes, q)]
    for lo in range(0, len(planes), step):
        replay = csd.rgb_to_yuv420_host_exact(planes[lo:lo + step], q)
        for name, d, h in zip("yuv", dev, replay):
            require(np.array_equal(d[lo:lo + step], h),
                    f"colorspace q{q} encode: {name} differs from the "
                    f"replay in planes {lo}..{lo + step - 1}")
    for k, p in enumerate(planes):
        for name, d, h in zip("yuv", dev, downsample_yuv420(p, q)):
            require(np.array_equal(d[k], h),
                    f"colorspace q{q} encode: {name} differs from the "
                    f"host colorspace in plane {k}")
    rgb = np.asarray(csd.yuv_to_rgb_device_exact(
        planes[..., 0], planes[..., 1], planes[..., 2], q))
    for k, p in enumerate(planes):
        require(np.array_equal(rgb[k], yuv_to_rgb(p[..., 0], p[..., 1],
                                                  p[..., 2], q)),
                f"colorspace q{q} decode differs in plane {k}")
    log(f"colorspace q{q}: all 2^24 triples equal in both directions"
        if planes.size == 3 << 24 else
        f"colorspace q{q}: {planes.size // 3} triples equal")


def run_one_card(seed: int) -> None:
    imgs = make_images(seed, BATCH)
    streams = phase_encode(imgs, 20, timed=True)
    log(f"processes on the card with the host pool up (pid {os.getpid()} "
        f"is this one): {card_processes()}")
    for q, sub in ((23, imgs[0::8]), (9, imgs[4::8])):
        streams += phase_encode(sub, q)
    for q in (20, 9):
        phase_scans(imgs[1:5], q)
    phase_decode(streams)
    planes = all_triples()
    for q in (20, 9):
        phase_colorspace(planes, q)


def run_cards(n: int, seed: int, n_images: int = 256) -> None:
    """The four-card path: data-parallel sharded encode + decode."""
    import jax

    from __graft_entry__ import check_sharded_back_end
    from nhwcodec_tpu.parallel import device_pipeline, mesh

    devs = jax.devices()
    require(len(devs) >= n, f"need {n} devices, have {len(devs)}")
    m = mesh.make_mesh(devs[:n])
    imgs = make_images(seed, n_images)
    streams = []
    for q in (20, 23):
        t0 = time.perf_counter()
        got, mp = mesh.encode_batch_sharded(m, imgs, q)
        dt = time.perf_counter() - t0
        check_streams(f"sharded encode q{q}", got, 0, host_encode(imgs, q))
        require(abs(mp - n_images * 512 * 512 / 1e6) < 1e-3,
                f"sharded megapixel count {mp}")
        log(f"sharded encode q{q} over {n} devices, {n_images} images: "
            f"byte-equal, {dt:.3f} s (compile included)")
        streams += got
    log(f"processes on the cards with the host pool up (pid "
        f"{os.getpid()} is this one): {card_processes()}")
    got, mt = device_pipeline.decode_batch_device(streams)
    require(mt.failures == 0, f"decode: {mt.failures} failures")
    want = host_decode(streams)
    bad = [i for i, (g, w) in enumerate(zip(got, want))
           if g is None or not np.array_equal(g, w)]
    require(not bad, f"decode differs from host decode at {bad[:8]}")
    log(f"decode of {len(streams)} sharded-encode streams: pixel-equal")
    check_sharded_back_end(m, 2 * n, np.random.default_rng(seed))
    log(f"sharded decode back end + requant tail over {n} devices: "
        f"equal to one device")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="4: run only the four-card sharded path")
    args = ap.parse_args(argv)

    import jax

    dev = phase_env()
    if args.cards == 1:
        run_one_card(args.seed)
    else:
        run_cards(args.cards, args.seed)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
