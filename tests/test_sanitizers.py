"""Sanitizer job for the vendored C oracle (SURVEY.md section 5).

The reference has known UB (documented out-of-bounds reads whose values
we emulate); this job builds the oracle under ASAN+UBSAN and checks that
a roundtrip still completes and produces the same bytes — pinning down
*which* UB is live so the emulation contract stays explicit.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))

from conftest import requires_oracle  # noqa: E402

import oracle  # noqa: E402


@pytest.fixture(scope="module")
def asan_bins():
    if not oracle.available():
        pytest.skip("reference sources not available")
    bin_dir = oracle.BIN
    bin_dir.mkdir(parents=True, exist_ok=True)
    enc = bin_dir / "nhw-enc-asan"
    dec = bin_dir / "nhw-dec-asan"
    flags = ["-O1", "-g", "-fsanitize=address,undefined",
             "-fsanitize-recover=address,undefined"]
    if not enc.exists():
        srcs = sorted(str(p) for p in (oracle.REFERENCE / "encoder"
                                       ).glob("*.c"))
        subprocess.run(["gcc", *flags, "-o", str(enc), *srcs, "-lm"],
                       check=True)
    if not dec.exists():
        srcs = sorted(str(p) for p in (oracle.REFERENCE / "decoder"
                                       ).glob("*.c"))
        subprocess.run(["gcc", *flags, "-o", str(dec), *srcs, "-lm"],
                       check=True)
    return enc, dec


@requires_oracle
def test_asan_documents_reference_oob_reads(asan_bins, fixture_dir,
                                            tmp_path):
    """ASAN on the reference encoder reports the heap out-of-bounds reads
    whose deterministic aliases this framework emulates
    (encoder/nhw_encoder.c:234 scan-ladder res256[count+1] etc.) — the
    sanitizer job pins down exactly which UB is live."""
    enc, _ = asan_bins
    env = dict(os.environ,
               ASAN_OPTIONS="detect_leaks=0:halt_on_error=0:"
                            "abort_on_error=0")
    r = subprocess.run(
        [str(enc), "-q20", "-f", str(fixture_dir / "flat.bmp"),
         str(tmp_path / "a.nhw")],
        env=env, capture_output=True, text=True)
    assert "heap-buffer-overflow" in r.stderr
    assert "nhw_encoder.c" in r.stderr


@requires_oracle
def test_decoder_known_findings_only_under_asan(asan_bins, fixture_dir,
                                                tmp_path):
    """The reference decoder on our encoder's output completes with only
    its *known* findings: misaligned u32 stores in the BMP header writer
    (decoder/nhw_decoder_cli.c setup) and the documented past-plane heap
    reads our decoder reproduces as zero-reads (models/decoder._read0).
    No new UB is triggered by the bytes we produce."""
    import nhwcodec_tpu
    from nhwcodec_tpu.utils import bmp as bmp_io

    _, dec = asan_bins
    env = dict(os.environ,
               ASAN_OPTIONS="detect_leaks=0:halt_on_error=0")
    rgb = bmp_io.read_bmp512(fixture_dir / "flat.bmp")
    nhw = tmp_path / "a.nhw"
    nhw.write_bytes(nhwcodec_tpu.encode(rgb, 20))
    out_bmp = tmp_path / "a.bmp"
    d = subprocess.run([str(dec), str(nhw), str(out_bmp)],
                       env=env, capture_output=True, text=True)
    assert d.returncode == 0, d.stderr[-2000:]
    assert out_bmp.exists() and out_bmp.stat().st_size > 0
    for line in d.stderr.splitlines():
        if "runtime error" in line:
            assert "misaligned address" in line, line
        if "ERROR: AddressSanitizer" in line:
            assert "heap-buffer-overflow" in line, line


def test_native_runtime_clean_under_asan(tmp_path):
    """Our own C runtime (hotpass.c) runs the full codec + a fuzz subset
    with zero AddressSanitizer findings — unlike the reference, whose OOB
    reads the two tests above document."""
    import shutil

    libasan = subprocess.run(
        ["gcc", "-print-file-name=libasan.so"],
        capture_output=True, text=True).stdout.strip()
    if not libasan or not Path(libasan).exists():
        pytest.skip("libasan not available")

    code = """
import numpy as np
import nhwcodec_tpu
from nhwcodec_tpu import native
from nhwcodec_tpu.utils import fixtures
assert native.available(), "ASAN build failed"
rng = np.random.default_rng(3)
for q in (8, 20, 23):
    data = nhwcodec_tpu.encode(fixtures.texture_noise(), q)
    nhwcodec_tpu.decode(data)
    for _ in range(25):
        buf = bytearray(data)
        buf[int(rng.integers(0, len(buf)))] = int(rng.integers(0, 256))
        try:
            nhwcodec_tpu.decode(bytes(buf))
        except Exception:
            pass
print("ASAN-CLEAN")
"""
    env = dict(os.environ, NHW_NATIVE_ASAN="1", LD_PRELOAD=libasan,
               ASAN_OPTIONS="detect_leaks=0")
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "ASAN-CLEAN" in r.stdout
    assert "AddressSanitizer" not in r.stderr
