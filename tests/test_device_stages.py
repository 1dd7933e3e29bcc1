"""models.device_stages: functional device analysis == in-place host driver.

The host driver (ops.analysis.wavelet_analysis) is oracle-dump-verified
(tests/test_encoder.py); the device stages must reproduce its exact
(jpeg, process, res256, snap) state for any input plane."""

import numpy as np
import pytest

from nhwcodec_tpu import tables as T
from nhwcodec_tpu.models import device_stages as ds
from nhwcodec_tpu.models.encoder import _pre_processing_uv
from nhwcodec_tpu.ops import analysis


def test_analysis_y_matches_host_driver():
    rng = np.random.default_rng(0)
    ys = rng.integers(-40, 296, (3, 512, 512)).astype(np.int16)
    dj, dp, dr, dsn = (np.asarray(a) for a in ds.analysis_y(ys))
    for i in range(3):
        jpeg = ys[i].copy()
        process = np.zeros((512, 512), np.int16)
        snap = analysis.wavelet_analysis(jpeg, process, 512, 0, 0,
                                         snapshot=True)
        res256 = jpeg[:256, :256].copy()
        analysis.wavelet_analysis(jpeg, process, 256, 1, 0)
        np.testing.assert_array_equal(dj[i], jpeg)
        np.testing.assert_array_equal(dp[i], process)
        np.testing.assert_array_equal(dr[i], res256)
        np.testing.assert_array_equal(dsn[i].reshape(-1), snap)


@pytest.mark.parametrize("q", [T.NORM, T.HIGH3, T.LOW6, T.LOW5, T.LOW4,
                               T.LOW9, T.LOW19])
def test_analysis_uv_matches_host_driver(q):
    rng = np.random.default_rng(q)
    c = rng.integers(0, 256, (2, 256, 256)).astype(np.uint8)
    dj, dp, dr = (np.asarray(a) for a in ds.analysis_uv(c, q))
    for i in range(2):
        jpeg = c[i].astype(np.int16).copy()
        process = np.zeros((256, 256), np.int16)
        if q <= T.LOW6:
            process[:] = jpeg
            _pre_processing_uv(jpeg, q)
        analysis.wavelet_analysis(jpeg, process, 256, 0, 0)
        res256 = jpeg[:128, :128].copy()
        if q <= T.LOW4:
            pf = process.reshape(-1)
            for r in range(128):
                for j in range(128, 256):
                    if 8 <= abs(int(pf[r * 256 + j])) < 24:
                        pf[r * 256 + j] = 0
            for r in range(128, 256):
                for j in range(128):
                    if 8 <= abs(int(pf[r * 256 + j])) < 32:
                        pf[r * 256 + j] = 0
                for j in range(128, 256):
                    if 8 <= abs(int(pf[r * 256 + j])) < 48:
                        pf[r * 256 + j] = 0
        analysis.wavelet_analysis(jpeg, process, 128, 1, 0)
        np.testing.assert_array_equal(dj[i], jpeg)
        np.testing.assert_array_equal(dp[i], process)
        np.testing.assert_array_equal(dr[i], res256)


@pytest.mark.parametrize("n", [128, 256, 512])
@pytest.mark.parametrize("direction", ["analysis", "synthesis"])
def test_level_matches_host_filterbank(direction, n):
    """One device filterbank level (device_stages._stage_xla for the
    analysis, device_decode._synth_level for the synthesis) equals the
    in-place host driver on the n x n block of the plane the codec runs
    that level in (128: UV level 2 in a 256-wide plane; 256: Y level 2
    in a 512-wide plane; 512: Y level 1), last stage: no LL
    transpose-back."""
    import jax.numpy as jnp

    from nhwcodec_tpu.models import device_decode as dd

    w = {128: 256, 256: 512, 512: 512}[n]
    rng = np.random.default_rng(n + len(direction))
    blk = rng.integers(-2048, 2048, (2, n, n)).astype(np.int16)
    if direction == "analysis":
        got = [np.asarray(a) for a in ds._stage_xla(jnp.asarray(blk))]
    else:
        got = [None, np.asarray(dd._synth_level(jnp.asarray(blk)))]
    for i in range(2):
        jpeg = np.zeros((w, w), np.int16)
        jpeg[:n, :n] = blk[i]
        process = np.zeros((w, w), np.int16)
        if direction == "analysis":
            analysis.wavelet_analysis(jpeg, process, n, 1, 0)
            np.testing.assert_array_equal(got[0][i], jpeg[:n, :n])
        else:
            analysis.wavelet_synthesis(jpeg, process, n, 1)
        np.testing.assert_array_equal(got[1][i], process[:n, :n])
