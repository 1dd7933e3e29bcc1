"""Device-wired batch fuzz wave.

Drives the production DEVICE paths — parallel.device_pipeline
(device transforms + default-on device bit packing) and
parallel.mesh.encode_batch_sharded (GSPMD front + process-pool host
half) — over a seeded wave of structured images at a mixed quality
set, and checks:

- every batch-encoded stream is byte-identical to the single-image
  host encoder (which the plain waves prove against the reference),
- every stream decodes pixel-identically through decode_batch_device
  vs the host decoder.

Run on the CPU backend for CI determinism (JAX_PLATFORMS=cpu) or on a
GPU card.  Usage:
  python tools/fuzz_wave_device.py <seed> [n_images] [--qualities ...]
Exit 0 iff zero mismatches.
"""

from __future__ import annotations

import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

from fuzz_wave import make_image  # noqa: E402


def main() -> int:
    import jax

    from nhwcodec_tpu.models import decoder, encoder
    from nhwcodec_tpu.parallel import device_pipeline, mesh

    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("seed", nargs="?", type=int, default=50)
    ap.add_argument("n_images", nargs="?", type=int, default=8)
    ap.add_argument("--qualities", type=lambda s: [int(x) for x in
                                                   s.split(",")],
                    default=[20, 23, 22, 19, 16, 8, 1])
    opts = ap.parse_args()
    seed, n, qs = opts.seed, opts.n_images, opts.qualities

    rng = np.random.default_rng(seed)
    imgs = np.stack([make_image(rng) for _ in range(n)])
    bad = []
    tested = 0
    for qi, q in enumerate(qs):
        want = [encoder.encode(imgs[i], q) for i in range(n)]

        got, _ = device_pipeline.encode_batch_device(imgs, q)
        for i in range(n):
            tested += 1
            if got[i] != want[i]:
                bad.append(("pipeline", q, i))

        # sharded mesh step on whatever devices this backend exposes
        m = mesh.make_mesh()
        got2, _ = mesh.encode_batch_sharded(m, imgs, q)
        for i in range(n):
            tested += 1
            if got2[i] != want[i]:
                bad.append(("sharded", q, i))

        # decode the batch back through the device-wired decoder
        want_px = [decoder.decode(w) for w in want]
        got_px, _ = device_pipeline.decode_batch_device(want)
        for i in range(n):
            tested += 1
            if not np.array_equal(want_px[i], got_px[i]):
                bad.append(("decode", q, i))

        # the full-device configurations: device encode scans and
        # device entropy decode
        from nhwcodec_tpu.models import device_decode as dd
        from nhwcodec_tpu.models import device_encode_scans as des

        if des.supported(q):
            got3, _ = device_pipeline.encode_batch_device(
                imgs, q, scans_on_device=True)
            for i in range(n):
                tested += 1
                if got3[i] != want[i]:
                    bad.append(("scans_on_device", q, i))
        got_px2 = dd.decode_batch_device(want, entropy_on_device=True)
        for i in range(n):
            tested += 1
            if not np.array_equal(want_px[i], got_px2[i]):
                bad.append(("entropy_on_device", q, i))
        print(f"q{q}: {tested} checks so far, {len(bad)} mismatches",
              flush=True)

    print(f"device wave {seed}: {tested} checks on "
          f"{jax.default_backend()} backend, {len(bad)} mismatches")
    if bad:
        print("MISMATCHES:", bad)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
