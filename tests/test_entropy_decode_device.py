"""Device Huffman decode (ops/entropy_decode_device) vs the host path.

Runs in a subprocess on the CPU JAX backend.
"""

import os
import subprocess
import sys
from pathlib import Path

from nhwcodec_tpu.utils.compile_cache import cache_dir

REPO = Path(__file__).resolve().parent.parent

_LUT_CODE = """
import numpy as np
from nhwcodec_tpu import tables as T
from nhwcodec_tpu.ops import entropy
from nhwcodec_tpu.ops.entropy_decode_device import _peek_lut, PEEK

rng = np.random.default_rng(0)

# every table code (and every zone escape), followed by random bits,
# must resolve to the same (symbol, length) as the host automaton
for zone_on in (False, True):
    lut = _peek_lut(zone_on)
    cases = [(int(T.HUFFMAN_CODES[j]), int(T.HUFFMAN_LENS[j])) for j in
             range(290)]
    if zone_on:
        cases += [((1 << 6) | k, 15) for k in range(64)]
    for c, ln in cases:
        tail = rng.integers(0, 2, 40)
        bits = [(c >> (ln - 1 - i)) & 1 for i in range(ln)] + tail.tolist()
        sym, pos = entropy._next_symbol(bits, 0, zone_on)
        peek = 0
        for k in range(PEEK):
            peek = (peek << 1) | bits[k]
        entry = int(lut[peek])
        assert entry & 0x3FF == sym, (zone_on, c, ln, sym, entry & 0x3FF)
        assert entry >> 10 == pos, (zone_on, c, ln, pos, entry >> 10)
print("OK")
"""

_STREAM_CODE = """
import numpy as np
from nhwcodec_tpu.models import encoder
from nhwcodec_tpu.utils import container, fixtures
from nhwcodec_tpu.ops import entropy, entropy_decode_device as edd

rng = np.random.default_rng(7)
imgs = {'grad': fixtures.gradient_circles(),
        'rand': rng.integers(0, 256, (512, 512, 3), dtype=np.uint8)}
for name, img in imgs.items():
    for q in (20, 8, 23):
        s = container.parse_nhw(encoder.encode(img, q))
        want_y = entropy.decode_y(s.packet1, s.tree1, s.select_word1,
                                  s.select_word2, s.res_high)
        got_y = edd.decode_y_device(s.packet1, s.tree1, s.select_word1,
                                    s.select_word2, s.res_high)
        np.testing.assert_array_equal(got_y, want_y, err_msg=f'{name} q{q} Y')
        want_uv = entropy.decode_uv(s.packet2, s.tree2, s.tree_end)
        got_uv = edd.decode_uv_device(s.packet2, s.tree2, s.tree_end)
        np.testing.assert_array_equal(got_uv, want_uv,
                                      err_msg=f'{name} q{q} UV')

# the runs-only automaton (the 2-3x shorter serial core) must agree
for name, img in imgs.items():
    for q in (20, 8, 23, 1, 16):
        s = container.parse_nhw(encoder.encode(img, q))
        want_y = entropy.decode_y(s.packet1, s.tree1, s.select_word1,
                                  s.select_word2, s.res_high)
        got_y = edd.decode_y_device(s.packet1, s.tree1, s.select_word1,
                                    s.select_word2, s.res_high,
                                    automaton='runs')
        np.testing.assert_array_equal(got_y, want_y,
                                      err_msg=f'runs {name} q{q}')

# chunked fixpoint: two shape classes (dense + sparse) single-stream,
# then the batched default path for both modes (CPU compile cost gates
# a wider sweep; tools/fuzz_wave_device.py covers the deployed batch
# paths wave-style, and chip_smoke.py runs the real shapes on the GPU)
for name, q in (('grad', 20), ('rand', 8)):
    s = container.parse_nhw(encoder.encode(imgs[name], q))
    want_y = entropy.decode_y(s.packet1, s.tree1, s.select_word1,
                              s.select_word2, s.res_high)
    got_y = edd.decode_y_device(s.packet1, s.tree1, s.select_word1,
                                s.select_word2, s.res_high,
                                automaton='chunked')
    np.testing.assert_array_equal(got_y, want_y,
                                  err_msg=f'chunked {name} q{q}')

# batched Y automaton: mixed-content batch, one quality
streams = [container.parse_nhw(encoder.encode(img, 20))
           for img in imgs.values()]
for mode in ('runs', 'chunked'):
    outs = edd.decode_y_device_batch(streams, automaton=mode)
    for s, got in zip(streams, outs):
        want = entropy.decode_y(s.packet1, s.tree1, s.select_word1,
                                s.select_word2, s.res_high)
        np.testing.assert_array_equal(got, want)

# batched UV decode: one chain + one scatter launch for the batch
uv_want = [entropy.decode_uv(s.packet2, s.tree2, s.tree_end)
           for s in streams]
for got, want in zip(edd.decode_uv_device_batch(streams), uv_want):
    np.testing.assert_array_equal(got, want, err_msg='uv batch')

# identical-rows invariance: every row of a [s, s, s] batch must decode
# the same (an XLA backend's flat-gather lowering decoded rows >= 1 of
# the fused emit differently until the take_along_axis fix — this is the
# minimal repro shape; same jit shapes as above, so no extra compile)
s0 = streams[0]
want0 = entropy.decode_y(s0.packet1, s0.tree1, s0.select_word1,
                         s0.select_word2, s0.res_high)
outs = edd.decode_y_device_batch([s0, s0], automaton='chunked')
for got in outs:
    np.testing.assert_array_equal(got, want0, err_msg='identical rows')
print("OK")
"""


def _run(code: str) -> None:
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    # persistent compile cache: the device-path programs cost minutes
    # to compile on XLA:CPU at real shapes, milliseconds when cached
    env["JAX_COMPILATION_CACHE_DIR"] = cache_dir()
    env["JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES"] = "-1"
    env["JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS"] = "1"
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=3000)
    assert out.returncode == 0, out.stderr
    assert "OK" in out.stdout


def test_peek_lut_matches_host_automaton():
    _run(_LUT_CODE)


def test_device_decode_bit_exact_on_real_streams():
    _run(_STREAM_CODE)


_FIXPOINT_CODE = """
import numpy as np
import jax.numpy as jnp
from nhwcodec_tpu import tables as T
from nhwcodec_tpu.models import encoder as enc_mod
from nhwcodec_tpu.ops import entropy
from nhwcodec_tpu.ops import entropy_decode_device as edd
from nhwcodec_tpu.utils import container, fixtures

# the chunk-relay fixpoint must converge in a handful of sweeps, not
# one-chunk-per-sweep (the round-5 prefix relay + mem/run_over clips;
# regression: sweeps == K was the deployed behavior before)
b = 4
streams = [container.parse_nhw(enc_mod.encode(g(), 20)) for g in
           (fixtures.texture_noise, fixtures.gradient_circles,
            fixtures.near_flat, fixtures.sharp_blocks)]
p1 = 4 * T.IM_SIZE
s_max = 1 << (min(p1, max(64, max(
    s.packet1.size * 32 for s in streams) // 2 + 2)) - 1).bit_length()
symB, countB = edd._chain_batch_scan(streams, s_max)
books = [entropy.build_y_book(s.tree1) for s in streams]
runs = [int(edd._run_count(symB[i], edd._book_device(*books[i])[0],
                           countB[i])) for i in range(b)]
s_trim = min(edd._bucket(int(np.asarray(countB).max()) + 1), s_max)
r_max = edd._bucket(max(max(runs), 1))

def pad_rows(rows):
    n = 1 << max(6, (max(len(r) for r in rows) - 1).bit_length())
    out = np.zeros((len(rows), n), np.int32)
    for i, r in enumerate(rows):
        out[i, :len(r)] = r
    return jnp.asarray(out)

vB = pad_rows([bk[0] for bk in books])
rB = pad_rows([bk[1] for bk in books])
k = 64 if r_max >= 64 else r_max
xs_t, lits = edd._runs_xs_batch(symB[:, :s_trim], vB, rB, p1, r_max, k)
ys, iters = edd._runs_fixpoint(xs_t, p1, k)
assert int(iters) <= 10, f"fixpoint took {int(iters)} sweeps (K={k})"

# the k+1 bound fallback: a non-converged fixpoint must route the batch
# through the sequential runs automaton and still decode bit-exactly
orig = edd._runs_fixpoint
def fake_fixpoint(xs_t, p1, k):
    ys, _ = orig(xs_t, p1, k)
    return ys, jnp.int32(k + 1)
edd._runs_fixpoint = fake_fixpoint
try:
    outs = edd.decode_y_device_batch(streams, automaton="chunked")
finally:
    edd._runs_fixpoint = orig
for s, got in zip(streams, outs):
    want = entropy.decode_y(s.packet1, s.tree1, s.select_word1,
                            s.select_word2, s.res_high)
    np.testing.assert_array_equal(got, want, err_msg="fallback path")
print("OK")
"""


def test_fixpoint_converges_fast_and_bound_falls_back():
    _run(_FIXPOINT_CODE)


def test_malformed_book_rejected_before_device_dispatch():
    """A run word with rle < 1 would break the emit scatters'
    unique-indices promise (every decoded symbol must advance the
    cursor); the host-side validation must reject it with a clear
    error instead of dispatching undefined scatters."""
    import pytest

    from nhwcodec_tpu.ops import entropy_decode_device as edd

    with pytest.raises(ValueError, match="rle < 1"):
        edd._check_book([5, 7], [3, 0], "Y")
    edd._check_book([5, 7], [3, 1], "Y")  # valid book passes
