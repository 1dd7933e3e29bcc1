"""The device-wired bit-exact encode path.

Three layers of evidence that the device transforms are load-bearing in
the real codec:

1. Device transform planes equal the ORACLE STAGE DUMPS directly
   (d1 colorspace, d3/d4 analysis states) for every quality 1..23.
2. encode_device() (device colorspace + device analysis feeding the
   host scans) is byte-identical to encode() across fixtures/qualities.
3. The batched pipelined path (parallel.device_pipeline) produces the
   same bytes with per-image failure isolation intact.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))

from conftest import requires_oracle  # noqa: E402

import oracle  # noqa: E402
import oracle_dump  # noqa: E402

from nhwcodec_tpu import tables as T  # noqa: E402
from nhwcodec_tpu.models import device_stages as ds  # noqa: E402
from nhwcodec_tpu.models import encoder  # noqa: E402
from nhwcodec_tpu.utils import bmp as bmp_io  # noqa: E402
from nhwcodec_tpu.utils import fixtures  # noqa: E402


@requires_oracle
def test_device_transform_equals_oracle_dumps_all_q(fixture_dir):
    """The device transform planes
    equal the oracle stage dumps for all q (d1 = colorspace output,
    d3/d4 = first/second analysis states; d5 is the post-requant state,
    still host-side).  One fixture, every quality 1..23."""
    src = fixture_dir / "gradient.bmp"
    rgb = bmp_io.read_bmp512(src)[None]
    for q in range(1, 24):
        d = oracle.ORACLE_DIR / "dumps" / f"gradient_q{q}"
        oracle_dump.run(src, q, d)
        dd = oracle_dump.load(d)

        y, u, v = ds.colorspace_front_device(rgb, q)
        np.testing.assert_array_equal(y[0], dd["d1_y"], err_msg=f"d1_y q{q}")
        np.testing.assert_array_equal(u[0], dd["d1_u"], err_msg=f"d1_u q{q}")
        np.testing.assert_array_equal(v[0], dd["d1_v"], err_msg=f"d1_v q{q}")

        # d2_jpeg = post-prefilter luma: the device analysis input
        jpeg, process, res256, _snap = (
            np.asarray(a) for a in ds.analysis_y(dd["d2_jpeg"][None]))
        np.testing.assert_array_equal(jpeg[0], dd["d4_jpeg"],
                                      err_msg=f"d4_jpeg q{q}")
        np.testing.assert_array_equal(process[0], dd["d4_process"],
                                      err_msg=f"d4_process q{q}")


@requires_oracle
def test_device_analysis_first_level_equals_d3(fixture_dir):
    """The intermediate (post level-1) state equals d3 directly."""
    d = oracle.ORACLE_DIR / "dumps" / "gradient_q20"
    oracle_dump.run(fixture_dir / "gradient.bmp", 20, d)
    dd = oracle_dump.load(d)
    j1, p1 = (np.asarray(a) for a in ds._stage(dd["d2_jpeg"][None]))
    jpeg = j1.copy()
    jpeg[:, :256, :256] = np.swapaxes(p1[:, :256, :256], -2, -1)
    np.testing.assert_array_equal(jpeg[0], dd["d3_jpeg"])
    np.testing.assert_array_equal(p1[0], dd["d3_process"])


@pytest.mark.parametrize("q", [23, 22, 20, 19, 17, 16, 12, 8, 1])
def test_encode_device_byte_identical(q):
    rng = np.random.default_rng(q)
    imgs = [fixtures.gradient_circles(), fixtures.texture_noise(),
            rng.integers(0, 256, (512, 512, 3), dtype=np.uint8)]
    for img in imgs:
        assert encoder.encode_device(img, q) == encoder.encode(img, q)


def test_encode_batch_device_pipelined():
    from nhwcodec_tpu.parallel import device_pipeline as dp

    imgs = np.stack([fixtures.gradient_circles(), fixtures.texture_noise(),
                     fixtures.sharp_blocks(), fixtures.near_flat()])
    want = [encoder.encode(imgs[i], 20) for i in range(4)]
    got, m = dp.encode_batch_device(imgs, 20, workers=2, chunk=2)
    assert m.failures == 0
    assert got == want


def test_encode_batch_device_low_quality():
    from nhwcodec_tpu.parallel import device_pipeline as dp

    imgs = np.stack([fixtures.gradient_circles(), fixtures.near_flat()])
    for q in (22, 11):
        want = [encoder.encode(imgs[i], q) for i in range(2)]
        got, m = dp.encode_batch_device(imgs, q, workers=2, chunk=1)
        assert m.failures == 0
        assert got == want
