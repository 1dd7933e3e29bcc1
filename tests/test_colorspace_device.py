"""Bit-exact device colorspace vs the oracle-verified host path.

The host path (ops.colorspace) is dump-verified against the reference
encoder; the device path must match it bit-for-bit.  The full 2^24
exhaustive sweep per float mode lives in tools/colorspace_exhaustive.py
(re-run on demand; ~15 min); here a structured + random slice of every
mode runs in CI, plus whole-pipeline equality on jax's CPU backend
(chip_smoke.py sweeps all 2^24 triples on the GPU)."""

import numpy as np
import pytest

from nhwcodec_tpu import tables as T
from nhwcodec_tpu.ops import colorspace as cs
from nhwcodec_tpu.ops import colorspace_device as csd
from nhwcodec_tpu.utils import fixtures

MODES = [T.NORM, T.LOW1, T.LOW2, T.LOW3, T.LOW4]


def _sample_rgb(rng, n):
    """Random triples + the rounding-boundary lattice (ties of the
    decimal matrices live on X % 1000 == 500 style surfaces)."""
    r = rng.integers(0, 256, (n, 3), dtype=np.uint8)
    # full planes of each channel against the extremes
    c = np.arange(256, dtype=np.uint8)
    grid = np.stack(np.meshgrid(c[::5], c[::5], c[::5]),
                    axis=-1).reshape(-1, 3).astype(np.uint8)
    ext = np.array([[0, 0, 0], [255, 255, 255], [255, 0, 0], [0, 255, 0],
                    [0, 0, 250], [0, 0, 255], [128, 128, 128]], np.uint8)
    return np.concatenate([r, grid, ext])


@pytest.mark.parametrize("q", MODES)
def test_matrix_slice_equality(q):
    rgb = _sample_rgb(np.random.default_rng(q), 200000).reshape(-1, 1, 3)
    y0, u0, v0 = cs.rgb_to_yuv(rgb, q)
    y1, u1, v1 = csd._yuv_full(rgb, q, np)
    assert np.array_equal(y0, y1)
    assert np.array_equal(u0, u1)
    assert np.array_equal(v0, v1)


@pytest.mark.parametrize("q", [23, 22, 20, 19, 18, 17, 16, 12, 8, 1])
def test_device_pipeline_equality(q):
    """jax path (jit, x64-traced) == host downsample_yuv420, per image."""
    rng = np.random.default_rng(7)
    imgs = np.stack([fixtures.gradient_circles(), fixtures.texture_noise(),
                     rng.integers(0, 256, (512, 512, 3), dtype=np.uint8)])
    y1, u1, v1 = csd.rgb_to_yuv420_device_exact(imgs, q)
    for i in range(len(imgs)):
        y0, u0, v0 = cs.downsample_yuv420(imgs[i], q)
        assert np.array_equal(np.asarray(y1[i]), y0)
        assert np.array_equal(np.asarray(u1[i]), u0)
        assert np.array_equal(np.asarray(v1[i]), v0)


# ---------------------------------------------------------------------------
# decode direction (YUV -> RGB): fixed-point replay vs the deployed host
# path (golden-BMP-verified native C).  The full 2^24-per-quality proof
# lives in tools/yuv_rgb_exhaustive.py (run: 0 mismatches, all 23 q).


def _sample_planes(rng):
    c = np.arange(256, dtype=np.uint8)
    yy, uu = np.meshgrid(c[::2], c[::2], indexing="ij")
    y = np.tile(yy, (4, 4))
    u = np.tile(uu, (4, 4))
    v = rng.integers(0, 256, y.shape, dtype=np.uint8)
    return y, u, v


@pytest.mark.parametrize("q", [23, 20, 19, 18, 17, 16, 9, 1])
def test_yuv_to_rgb_replay_matches_host(q):
    from nhwcodec_tpu.models.decoder import yuv_to_rgb

    y, u, v = _sample_planes(np.random.default_rng(q))
    want = yuv_to_rgb(y, u, v, q)
    got = csd.yuv_to_rgb_host_exact(y, u, v, q)
    np.testing.assert_array_equal(want, got)


@pytest.mark.parametrize("q", [20, 17, 18, 9])
def test_yuv_to_rgb_device_matches_host(q):
    from nhwcodec_tpu.models.decoder import yuv_to_rgb

    y, u, v = _sample_planes(np.random.default_rng(100 + q))
    want = yuv_to_rgb(y, u, v, q)
    got = np.asarray(csd.yuv_to_rgb_device_exact(
        y[None], u[None], v[None], q))[0]
    np.testing.assert_array_equal(want, got)
