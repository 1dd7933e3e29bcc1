"""u32-limb colorspace (ops.colorspace_limb) vs the proven replay.

The limb chain is the deployed q >= NORM device program (encode and
mode-0 decode); its spec is the uint64 replay in ops.colorspace_device
(itself proven vs the oracle-verified host path over all 2^24 inputs).
The full 2^24 proof of the limb forms lives in
tools/colorspace_limb_exhaustive.py; here structured + random slices
run in CI, numpy and jnp lanes compared for identity.
"""

import numpy as np
import pytest

from nhwcodec_tpu.ops import colorspace_device as csd
from nhwcodec_tpu.ops import colorspace_limb as cl


def _triples(seed):
    rng = np.random.default_rng(seed)
    r = rng.integers(0, 256, (100000, 3), dtype=np.uint8)
    c = np.arange(256, dtype=np.uint8)
    grid = np.stack(np.meshgrid(c[::7], c[::7], c[::7]),
                    axis=-1).reshape(-1, 3).astype(np.uint8)
    ext = np.array([[0, 0, 0], [255, 255, 255], [255, 0, 0], [0, 255, 0],
                    [0, 0, 255], [1, 0, 0], [0, 0, 1], [128, 128, 128],
                    [255, 255, 0], [0, 255, 255]], np.uint8)
    return np.concatenate([r, grid, ext])


def test_encode_limb_matches_u64_replay():
    t = _triples(3)
    r, g, b = t[:, 0], t[:, 1], t[:, 2]
    y0 = csd._y_fast(r.astype(np.uint64), g.astype(np.uint64),
                     b.astype(np.uint64), np)
    u0 = csd._chroma_fast(r, g, b, csd._MI_U, (-1, -1, 1), np)
    v0 = csd._chroma_fast(r, g, b, csd._MI_V, (1, -1, -1), np)
    y1, u1, v1 = cl.yuv_norm_limb(r, g, b, np)
    assert np.array_equal(y0, y1)
    assert np.array_equal(u0, u1)
    assert np.array_equal(v0, v1)


def test_decode_limb_matches_i64_replay():
    t = _triples(4)
    y, u, v = t[:, 0], t[:, 1], t[:, 2]
    ir, ig, ib = csd._dec_inner54(y.astype(np.int64) << 54,
                                  u.astype(np.int64) - 128,
                                  v.astype(np.int64) - 128, np)
    r0 = csd._half_trunc54(ir, np)
    g0 = csd._half_trunc54(ig, np)
    b0 = csd._half_trunc54(ib, np)
    r1, g1, b1 = cl.rgb_mode0_limb(y, u, v, np)
    assert np.array_equal(r0, r1)
    assert np.array_equal(g0, g1)
    assert np.array_equal(b0, b1)


def test_jnp_lanes_identical_to_numpy():
    import jax.numpy as jnp

    t = _triples(5)
    r, g, b = t[:, 0], t[:, 1], t[:, 2]
    enc_np = cl.yuv_norm_limb(r, g, b, np)
    enc_j = cl.yuv_norm_limb(jnp.asarray(r), jnp.asarray(g),
                             jnp.asarray(b), jnp)
    dec_np = cl.rgb_mode0_limb(r, g, b, np)
    dec_j = cl.rgb_mode0_limb(jnp.asarray(r), jnp.asarray(g),
                              jnp.asarray(b), jnp)
    for a, bb in zip(enc_np + dec_np, enc_j + dec_j):
        assert np.array_equal(a, np.asarray(bb))


@pytest.mark.parametrize("shift_target", [0, 1, 11, 24, 31, 32, 39, 40])
def test_rne24_pair_edges(shift_target):
    """Cross-limb RNE24 against a python-int oracle at every shift
    regime (incl. the 31/32 limb-boundary shifts)."""
    rng = np.random.default_rng(shift_target)
    bl = 24 + shift_target
    vals = (rng.integers(0, 1 << (bl - 1), 1000, dtype=np.uint64)
            | np.uint64(1 << (bl - 1)))
    # force exact ties and near-ties
    if shift_target > 0:
        base = (vals >> np.uint64(shift_target)) << np.uint64(shift_target)
        half = np.uint64(1 << (shift_target - 1))
        vals = np.concatenate([vals, base | half, base | (half - 1),
                               base | (half + 1)])
    hi = (vals >> np.uint64(32)).astype(np.uint32)
    lo = vals.astype(np.uint32)
    got_h, got_l = cl._rne24_pair(hi, lo, np)
    got = got_h.astype(np.uint64) << np.uint64(32) | got_l.astype(np.uint64)
    want = csd._rne_u64(vals, 24, np)
    assert np.array_equal(got, want)
