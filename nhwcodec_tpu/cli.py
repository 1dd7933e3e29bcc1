"""nhw-enc / nhw-dec compatible command-line interface.

Mirrors the reference CLIs (encoder/nhw_encoder_cli.c:88-186,
decoder/nhw_decoder_cli.c:67-93): ``nhw-enc [-q1..23] [-f] in.bmp out.nhw``
and ``nhw-dec in.nhw out.bmp``.  The reference accepts -q0 but q=0 is
undefined behavior there (uninitialized quantization table); this CLI
rejects it.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def enc_main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="nhw-enc", description="NHW image encoder")
    ap.add_argument("input", help="512x512 24bpp BMP input")
    ap.add_argument("output", help=".nhw output")
    ap.add_argument("-q", type=int, default=20, metavar="1..23",
                    help="quality setting (default 20)")
    ap.add_argument("-f", action="store_true", help="overwrite output")
    args = ap.parse_args(argv)

    if not 1 <= args.q <= 23:
        print("error: quality must be 1..23 (the reference accepts -q0 "
              "but its behavior there is undefined)", file=sys.stderr)
        return 2
    out = Path(args.output)
    if out.exists() and not args.f:
        print(f"error: {out} exists (use -f to overwrite)", file=sys.stderr)
        return 2

    import nhwcodec_tpu
    from nhwcodec_tpu.utils import bmp
    from nhwcodec_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    rgb = bmp.read_bmp512(args.input)
    out.write_bytes(nhwcodec_tpu.encode(rgb, args.q))
    return 0


def dec_main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="nhw-dec", description="NHW image decoder")
    ap.add_argument("input", help=".nhw input")
    ap.add_argument("output", help="BMP output")
    args = ap.parse_args(argv)

    import nhwcodec_tpu
    from nhwcodec_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    nhwcodec_tpu.decode_to_bmp(args.input, args.output)
    return 0


def main() -> int:
    """Dispatch on argv[0] basename or first arg (enc/dec)."""
    prog = Path(sys.argv[0]).name
    if "dec" in prog:
        return dec_main()
    if "enc" in prog:
        return enc_main()
    if len(sys.argv) > 1 and sys.argv[1] in ("enc", "dec"):
        fn = enc_main if sys.argv[1] == "enc" else dec_main
        return fn(sys.argv[2:])
    print("usage: python -m nhwcodec_tpu.cli {enc|dec} ...", file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
