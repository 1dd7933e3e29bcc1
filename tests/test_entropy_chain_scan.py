"""Gather-free chain extraction (ops/entropy_chain_scan) vs the
pointer-doubling formulation and the peek LUT.

Runs in-process on the CPU backend; the big real-stream equality lives in
tests/test_entropy_decode_device.py (the public decode paths route
through the new chain).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from nhwcodec_tpu.ops import entropy_chain_scan as ecs            # noqa: E402
from nhwcodec_tpu.ops import entropy_decode_device as edd         # noqa: E402


@pytest.mark.parametrize("zone", [0, 1])
def test_segment_cascade_equals_peek_lut(zone):
    """The 26/28-segment threshold cascade is a lossless re-encoding of
    the 2^20-entry peek LUT (exhaustive)."""
    lut = edd._peek_lut(bool(zone))
    pk = jnp.asarray(np.arange(1 << 20, dtype=np.int32))
    ln, sym = jax.jit(ecs._lens_syms)(pk, jnp.int32(zone))
    assert np.array_equal(np.asarray(ln), lut >> 10)
    assert np.array_equal(np.asarray(sym), lut & 0x3FF)


def test_chain_matches_pointer_doubling_on_random_words():
    rng = np.random.default_rng(3)
    nw = 256
    s_max = 4096
    for trial in range(3):
        words = rng.integers(0, 1 << 32, (2, nw),
                             dtype=np.uint64).astype(np.uint32)
        nbits = np.array([nw * 32 - 13, nw * 16], np.int32)
        zone = np.array([trial & 1, 1 - (trial & 1)], np.int32)
        s_old, c_old = edd._codeword_chain_batch(
            jnp.asarray(words), jnp.asarray(nbits), jnp.asarray(zone),
            s_max)
        s_new, c_new = ecs.chain_starts_batch(
            jnp.asarray(words), jnp.asarray(nbits), jnp.asarray(zone),
            s_max)
        c_old = np.asarray(c_old)
        assert np.array_equal(c_old, np.asarray(c_new))
        for i in range(2):
            n_cmp = min(int(c_old[i]) + 1, s_max)
            assert np.array_equal(np.asarray(s_old)[i, :n_cmp],
                                  np.asarray(s_new)[i, :n_cmp]), (trial, i)
