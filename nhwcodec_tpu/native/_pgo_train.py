"""PGO training driver (run as a subprocess by native._load).

Loads the instrumented hotpass library given on the command line,
injects it as THE native runtime, and runs a small representative
workload (encode+decode across the quality branches) so gcc's
-fprofile-use rebuild sees realistic branch/block counts for the
raster automata.  Must not import jax or touch any accelerator.
"""

from __future__ import annotations

import os
import sys


def main(so_path: str) -> int:
    import ctypes

    os.environ.setdefault("JAX_PLATFORMS", "cpu")

    import nhwcodec_tpu.native as native

    # pre-seed the loaded lib so models/* never trigger a build
    lib = ctypes.CDLL(so_path)
    native._bind(lib)
    native._lib = lib
    native._ffi = native._Ffi()

    from nhwcodec_tpu.models import decoder, encoder
    from nhwcodec_tpu.utils import fixtures

    imgs = [fixtures.gradient_circles(), fixtures.texture_noise(),
            fixtures.sharp_blocks(), fixtures.near_flat()]
    # one quality per distinct branch family: NORM fast path (20), the
    # HQ residue path (23), low-q prefilter ladders (9), the lowest
    # cleanup path (3), the LOW4 integer colorspace (16), LOW1 gain (19)
    for q in (20, 23, 9, 3, 16, 19):
        for im in imgs:
            decoder.decode(encoder.encode(im, q))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
