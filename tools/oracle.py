"""Golden-oracle harness: builds and runs the reference C codec.

The reference sources live read-only at ``/root/reference`` (or
``$NHW_REFERENCE``).  Binaries are compiled out-of-tree into
``.oracle/bin`` (gitignored) and used by the test-suite as the
bit-exactness oracle.  No reference code is vendored into this repo.
"""

from __future__ import annotations

import os
import subprocess
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
REFERENCE = Path(os.environ.get("NHW_REFERENCE", "/root/reference"))
ORACLE_DIR = REPO / ".oracle"
BIN = ORACLE_DIR / "bin"
FIXTURES = ORACLE_DIR / "fixtures"


def available() -> bool:
    return REFERENCE.is_dir() and (REFERENCE / "encoder").is_dir()


def build() -> tuple[Path, Path]:
    """Compile nhw-enc / nhw-dec from the reference sources (cached)."""
    enc, dec = BIN / "nhw-enc", BIN / "nhw-dec"
    if enc.exists() and dec.exists():
        return enc, dec
    if not available():
        raise RuntimeError(f"reference sources not found at {REFERENCE}")
    BIN.mkdir(parents=True, exist_ok=True)
    enc_srcs = sorted(str(p) for p in (REFERENCE / "encoder").glob("*.c"))
    dec_srcs = sorted(str(p) for p in (REFERENCE / "decoder").glob("*.c"))
    subprocess.run(["gcc", "-O2", "-o", str(enc), *enc_srcs, "-lm"], check=True)
    subprocess.run(["gcc", "-O2", "-o", str(dec), *dec_srcs, "-lm"], check=True)
    return enc, dec


def encode(bmp: Path, nhw: Path, q: int = 20) -> None:
    enc, _ = build()
    subprocess.run([str(enc), f"-q{q}", "-f", str(bmp), str(nhw)],
                   check=True, capture_output=True)


def decode(nhw: Path, bmp: Path) -> None:
    _, dec = build()
    subprocess.run([str(dec), str(nhw), str(bmp)],
                   check=True, capture_output=True)


_ZMALLOC_C = r"""
/* zero-filling malloc for deterministic encoder output: the reference
   packs uninitialized malloc tail bits into a few dead file bytes. */
#define _GNU_SOURCE
#include <stddef.h>
#include <string.h>
extern void *__libc_malloc(size_t);
void *malloc(size_t n) {
    void *p = __libc_malloc(n);
    if (p) memset(p, 0, n);
    return p;
}
"""


def build_zmalloc() -> Path:
    so = BIN / "zmalloc.so"
    if so.exists():
        return so
    BIN.mkdir(parents=True, exist_ok=True)
    src = BIN / "zmalloc.c"
    src.write_text(_ZMALLOC_C)
    subprocess.run(["gcc", "-shared", "-fPIC", "-O2", "-o", str(so),
                    str(src)], check=True)
    return so


def encode_det(bmp: Path, nhw: Path, q: int = 20) -> None:
    """Encode with zero-filled malloc: deterministic dead bits."""
    enc, _ = build()
    so = build_zmalloc()
    env = dict(os.environ, LD_PRELOAD=str(so))
    subprocess.run([str(enc), f"-q{q}", "-f", str(bmp), str(nhw)],
                   check=True, capture_output=True, env=env)


_BVA_CALL = "//if (im->setup->quality_setting<=LOW6) block_variance_avg(im);"


def build_bva() -> Path:
    """Instrumented encoder with the dead block_variance_avg call
    re-enabled (encoder/nhw_encoder.c:112) — the oracle for the
    flag-gated E6 implementation."""
    import shutil

    enc = BIN / "nhw-enc-bva"
    if enc.exists():
        return enc
    src_dir = ORACLE_DIR / "src_enc_bva"
    if src_dir.exists():
        shutil.rmtree(src_dir)
    src_dir.mkdir(parents=True)
    for p in (REFERENCE / "encoder").iterdir():
        shutil.copy(p, src_dir / p.name)
    main = src_dir / "nhw_encoder.c"
    text = main.read_text()
    assert _BVA_CALL in text, "BVA call anchor not found"
    main.write_text(text.replace(_BVA_CALL, _BVA_CALL.lstrip("/")))
    BIN.mkdir(parents=True, exist_ok=True)
    srcs = sorted(str(p) for p in src_dir.glob("*.c"))
    subprocess.run(["gcc", "-O2", "-o", str(enc), *srcs, "-lm"], check=True)
    return enc


def encode_bva_det(bmp: Path, nhw: Path, q: int = 20) -> None:
    """Deterministic encode through the BVA-enabled oracle build."""
    enc = build_bva()
    so = build_zmalloc()
    env = dict(os.environ, LD_PRELOAD=str(so))
    subprocess.run([str(enc), f"-q{q}", "-f", str(bmp), str(nhw)],
                   check=True, capture_output=True, env=env)
