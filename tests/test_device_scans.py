"""Device encoder scans (models/device_scans, device_encode_scans) vs
the host C scans — unit equalities on adversarial planes plus the full
scans-on-device encode configuration byte-identical to encode().

Runs in a subprocess on the CPU JAX backend.
"""

import os
import subprocess
import sys
from pathlib import Path

from nhwcodec_tpu.utils.compile_cache import cache_dir

REPO = Path(__file__).resolve().parent.parent

_UNIT_CODE = """
import numpy as np
from nhwcodec_tpu.models import encoder as enc_mod
from nhwcodec_tpu.models import device_scans as ds
from nhwcodec_tpu.ops import quantize, residue

rng = np.random.default_rng(7)

# snap passes: adversarial chain plane across the three variants
chain = rng.choice(np.array([7, 8, 9, -7, -8, -15, -16, 6, -6, 0,
                             12900, 10100], np.int16),
                   size=(512, 512),
                   p=[.1, .1, .1, .1, .1, .15, .15, .05, .05, .05,
                      .025, .025])
for rows, c0, c1, thr, yw, yw2, sec, g6, gc in (
        (range(1, 255), 257, 511, 6, 8, 4, False, True, 510),
        (range(256, 511), 1, 256, 6, 8, 9, True, False, 254),
        (range(256, 511), 257, 511, 7, 11, 11, False, False, 510)):
    ref = np.concatenate([chain.reshape(-1).copy(),
                          np.zeros(8, np.int16)])
    enc_mod._band_snap_pass(ref, rows, c0, c1, thr, yw, yw2, sec, g6, gc)
    got = np.asarray(ds.snap_pass_device(
        chain[None], rows.start, rows.stop, c0, c1, thr, yw, yw2,
        sec, g6, gc))[0]
    assert np.array_equal(got.reshape(-1), ref[:512 * 512])

# quantizers
p = rng.integers(-400, 401, (512, 512)).astype(np.int16)
ref = p.copy(); quantize.offset_y(ref, 20, 8)
assert np.array_equal(np.asarray(ds.offset_y_device(p[None], 8))[0], ref)
pu = rng.choice(np.array([7, 14, 8, -7, -8, 0, 200, -200, 12400],
                         np.int16), size=(256, 256))
ref = pu.copy(); quantize.offset_uv(ref, 8)
assert np.array_equal(np.asarray(ds.offset_uv_device(pu[None], 8))[0],
                      ref)

# pair promotion
pp = rng.choice(np.array([5, 6, 7, 8, -5, -6, -7, -8, 0, 9, -9, 12],
                         np.int16), size=(512, 512))
ref = pp.reshape(-1).copy(); enc_mod._pair_promotion(ref, 20)
assert np.array_equal(
    np.asarray(ds.pair_promotion_device(pp[None]))[0].reshape(-1), ref)

# column ladder + classify on realistic delta planes
p = rng.integers(-12, 13, (512, 512)).astype(np.int16)
r256 = (p[:256, :256] + rng.integers(-6, 7, (256, 256))).astype(np.int16)
resIII = rng.integers(-20, 21, (256, 256)).astype(np.int16)
khead = rng.integers(-5, 6, 4).astype(np.int16)
refp, refr = p.copy(), r256.copy()
residue.res256_column_ladder(refp, refr, 20, 3, resIII,
                             kernel_head=khead)
oob = np.zeros(1024, np.int16)
oob[0:4] = khead; oob[4:8] = [17, 2, 0, 0]
oob[8:] = resIII.reshape(-1)[:1016]
rf_ext = np.concatenate([r256.reshape(-1), oob])
gp, gr = ds.column_ladder_device(p[None], rf_ext[None], 20, 3)
assert np.array_equal(np.asarray(gp)[0], refp)
assert np.array_equal(np.asarray(gr)[0].reshape(256, 256), refr)
n1, n3, n5 = residue.res256_classify(refp, refr, 20, 3)
gp2, gr2, g1, g3, g5 = ds.classify_device(np.asarray(gp),
                                          np.asarray(gr).reshape(1, 256, 256),
                                          20, 3)
assert np.array_equal(np.asarray(gp2)[0], refp)
assert np.array_equal(np.asarray(gr2)[0], refr)
assert (int(g1[0]), int(g3[0]), int(g5[0])) == (n1, n3, n5)
print("OK")
"""

_LOWQ_CODE = """
import numpy as np
from nhwcodec_tpu.models import encoder as enc_mod
from nhwcodec_tpu.models import device_scans as ds
from nhwcodec_tpu.ops import quantize

rng = np.random.default_rng(11)

# low-q LL1 isolated-coefficient zeroing (q<=LOW9)
p = rng.choice(np.array([0, 3, 7, 8, 9, 10, -8, -9, -10, 20, -20],
                        np.int16), size=(512, 512))
ref = p.reshape(-1).copy()
enc_mod._low_q_ll1_cleanup(ref, 11, 8)
got = np.asarray(ds.low_q_ll1_cleanup_device(p[None], 10))[0]
assert np.array_equal(got.reshape(-1), ref)

# very-low-q window ladders (q<LOW7)
p = rng.choice(np.array([0, 2, 5, 7, 8, 10, 12, 14, -7, -10, -14, 33,
                         40, -40], np.int16), size=(512, 512))
ref = p.reshape(-1).copy()
enc_mod._very_low_q_cleanup(ref, 9, 8)
got = np.asarray(ds.very_low_q_cleanup_device(
    p[None], 9, enc_mod._VLQ_THRX(9, None)))[0]
assert np.array_equal(got.reshape(-1), ref)

# lowest-q band cleanup (q<LOW6) with the zero-tail r3 model
p = rng.choice(np.array([0, 5, 8, 12, 15, 17, 19, 25, 28, -12, -17,
                         -28, 60, -60], np.int16), size=(512, 512))
resIII = rng.integers(-30, 31, (256, 256)).astype(np.int16)
ref = p.reshape(-1).copy()
enc_mod._lowest_q_band_cleanup(ref, resIII, 9, 8)
xs = enc_mod._lowest_q_xs(p.reshape(-1), 9)
oob = np.zeros(256, np.int16)
oob[4] = 24593
r3_ext = np.concatenate([resIII.reshape(-1), oob])
got = np.asarray(ds.lowest_q_band_cleanup_device(
    p[None], r3_ext[None], 9, xs))[0]
assert np.array_equal(got.reshape(-1), ref)

# UV LL smoothing (q<=LOW9): true sequential column scan
pu = rng.choice(np.array([0, 4, 7, 9, 12, -4, -9, -12, 100, -100],
                         np.int16), size=(256, 256))
ref = pu.copy()
enc_mod._uv_ll_smooth(ref)
got = np.asarray(ds.uv_ll_smooth_device(pu[None]))[0]
assert np.array_equal(got, ref)

# the q<=LOW4 duty-cycle quantizer
p = rng.integers(-400, 401, (512, 512)).astype(np.int16)
ref = p.copy(); quantize.offset_y(ref, 9, 8)
assert np.array_equal(np.asarray(ds.offset_y_low4_device(p[None], 8))[0],
                      ref)

# low56 dead-zoning (pure vector)
p = rng.integers(-25, 26, (512, 512)).astype(np.int16)
ref = p.reshape(-1).copy()
enc_mod._low56_band_cleanup(ref, 15, 8)
got = np.asarray(ds.low56_band_cleanup_device(p[None], 19))[0]
assert np.array_equal(got.reshape(-1), ref)
print("OK")
"""

_E2E_CODE = """
import numpy as np
from nhwcodec_tpu.models import encoder as enc
from nhwcodec_tpu.models import device_encode_scans as des
from nhwcodec_tpu.utils import fixtures

imgs = np.stack([fixtures.texture_noise(), fixtures.gradient_circles()])
for q in (20, 19, 21):
    refs = [enc.encode(im, q) for im in imgs]
    gots = des.encode_batch_scans_device(imgs, q)
    for r, g in zip(refs, gots):
        assert r == g, f"scans-on-device encode differs at q{q}"
print("OK")
"""


_E2E_LOWQ_CODE = """
import numpy as np
from nhwcodec_tpu.models import encoder as enc
from nhwcodec_tpu.models import device_encode_scans as des
from nhwcodec_tpu.utils import fixtures

imgs = np.stack([fixtures.texture_noise(), fixtures.gradient_circles()])
for q in (16, 9, 3):
    refs = [enc.encode(im, q) for im in imgs]
    gots = des.encode_batch_scans_device(imgs, q)
    for r, g in zip(refs, gots):
        assert r == g, f"scans-on-device encode differs at q{q}"
print("OK")
"""


def _run(code: str) -> None:
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["JAX_COMPILATION_CACHE_DIR"] = cache_dir()
    env["JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES"] = "-1"
    env["JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS"] = "1"
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=3000)
    assert out.returncode == 0, out.stderr
    assert "OK" in out.stdout


def test_device_scan_units_bit_exact():
    _run(_UNIT_CODE)


def test_scans_on_device_encode_byte_identical():
    _run(_E2E_CODE)


def test_device_scan_lowq_units_bit_exact():
    _run(_LOWQ_CODE)


def test_scans_on_device_encode_low_q_byte_identical():
    _run(_E2E_LOWQ_CODE)
