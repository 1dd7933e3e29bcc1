"""models.device_decode: device synthesis back end == host decoder.

The host decoder is golden-BMP-verified (tests/test_decoder.py); the
device back end must reproduce it bit-for-bit.  The device programs are
backend-portable: XLA:CPU in CI, the GPU in chip_smoke.py.
"""

import numpy as np
import pytest

from nhwcodec_tpu.models import decoder, device_decode, encoder
from nhwcodec_tpu.utils import fixtures


def _streams(qs):
    gens = list(fixtures.GENERATORS.values())
    return [encoder.encode(gens[i % len(gens)](), q)
            for i, q in enumerate(qs)]


@pytest.mark.parametrize("q", [1, 8, 16, 20, 22, 23])
def test_decode_batch_device_matches_host(q):
    datas = _streams([q, q])
    want = [decoder.decode(d) for d in datas]
    got = device_decode.decode_batch_device(datas)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w, g)


def test_decode_batch_device_mixed_qualities():
    # the device programs are quality-independent: one batch, four q's
    datas = _streams([4, 14, 19, 21])
    want = [decoder.decode(d) for d in datas]
    got = device_decode.decode_batch_device(datas)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w, g)


def test_decode_batch_device_pipeline():
    from nhwcodec_tpu.parallel import device_pipeline as dp

    datas = _streams([20, 3, 22, 20, 15])
    out, m = dp.decode_batch_device(datas, workers=2, chunk=2)
    assert m.failures == 0 and m.images == 5
    for d, rgb in zip(datas, out):
        np.testing.assert_array_equal(rgb, decoder.decode(d))


def test_decode_batch_device_entropy_on_device():
    # the full-device decode configuration: Huffman unpackers on the
    # device too (ops.entropy_decode_device), bit-identical output
    datas = _streams([20, 20])
    want = [decoder.decode(d) for d in datas]
    got = device_decode.decode_batch_device(datas,
                                            entropy_on_device=True)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w, g)


def test_decode_batch_device_pipeline_failure_isolation():
    from nhwcodec_tpu.parallel import device_pipeline as dp

    datas = _streams([20, 20])
    bad = b"\x00\x01" + b"\x00" * 40  # structurally hopeless stream
    out, m = dp.decode_batch_device([datas[0], bad, datas[1]], chunk=3)
    assert m.failures == 1
    assert out[1] is None
    np.testing.assert_array_equal(out[0], decoder.decode(datas[0]))
    np.testing.assert_array_equal(out[2], decoder.decode(datas[1]))


def test_mark_smoothing_dense_waves_equal_sequential_scan():
    """The dering mark smoothing as depth waves (y_stage2_dense_device)
    must match the per-mark sequential scan exactly, including same-row
    adjacent chains (run depth > 1) and the monotonicity fallback."""
    import jax.numpy as jnp

    from nhwcodec_tpu.models import device_decode as dd

    rng = np.random.default_rng(3)
    b = 2
    yc = jnp.asarray(rng.integers(-3000, 3000, (b, 512, 512))
                     .astype(np.int16))
    proc = (np.asarray(yc)[:, :256, :256] >> 1).astype(np.int16)
    idx = jnp.asarray(rng.integers(0, 512 * 512, (b, 16))
                      .astype(np.int32))
    dl = jnp.asarray(rng.integers(-30, 31, (b, 16)).astype(np.int16))
    marks_list = []
    for _ in range(b):
        ms = []
        for r in sorted(rng.choice(np.arange(1, 255), 30,
                                   replace=False)):
            run0 = int(rng.integers(1, 240))
            cs = sorted(set(rng.integers(1, 250, 5).tolist()
                            + [run0, run0 + 1, run0 + 2]))
            ms.extend([(int(r) << 8) | int(c) for c in cs])
        ms.sort(key=lambda m: ((m & 255), (m >> 8)))  # C emission order
        marks_list.append(ms)
    dp_, n_waves, ok = dd.mark_depth_planes(marks_list)
    assert ok and n_waves >= 2
    recs, valid = dd.pad_marks(marks_list)
    ref = np.asarray(dd.y_stage2_device(yc, jnp.asarray(proc), idx, dl,
                                        recs, valid))
    got = np.asarray(dd.y_stage2_dense_device(
        yc, jnp.asarray(proc), idx, dl, jnp.asarray(dp_), n_waves))
    np.testing.assert_array_equal(got, ref)

    # the no-HQ one-program configuration (hq arrays None)
    ref0 = np.asarray(dd.y_stage2_device(
        yc, jnp.asarray(proc), jnp.zeros((b, 8), jnp.int32),
        jnp.zeros((b, 8), jnp.int16), recs, valid))
    got0 = np.asarray(dd.y_stage2_dense_device(
        yc, jnp.asarray(proc), None, None, jnp.asarray(dp_), n_waves))
    np.testing.assert_array_equal(got0, ref0)

    # out-of-order same-row emission must be rejected (fallback path)
    badlist = [[(5 << 8) | 9, (5 << 8) | 8]]
    _, _, ok2 = dd.mark_depth_planes(badlist)
    assert not ok2
