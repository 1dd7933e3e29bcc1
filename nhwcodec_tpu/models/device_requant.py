"""Device formulation of the encoder's requantization feedback tail.

The requant block (encoder/nhw_encoder.c:141-283) is:

  mark_res256 -> offsetY_recons256(part=1) -> wavelet_synthesis(256)
  -> unmark_res256 -> scan ladder -> wavelet_analysis(256, last)

The first two passes are greedy raster automata with data-dependent
advancement (they stay on host); everything from the synthesis onward is
one batched device program here:

- synthesis: one slice-algebra level plus the driver's LL transpose
- unmark: the sentinel scatter into the synthesized plane is a fixed
  bijection per region, so it lowers to three strided slice-adds
  (encoder/nhw_encoder.c:183-216)
- the ±7/4/2/1 compare ladder (encoder/nhw_encoder.c:218-279): the
  sequential raster pass reads the *updated* left neighbour, i.e. each
  position's nudge depends only on its left chain — an acyclic
  dependency, so Jacobi iteration (a `lax.while_loop` re-evaluating the
  vectorized decision with the previous iterate's left nudges) reaches
  the exact sequential fixpoint in at most chain-length steps
- the second-level re-analysis: device_stages' (j, p) stage

Equality vs the host block on real encode states and adversarial planes:
tests/test_device_requant.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from nhwcodec_tpu.models.device_stages import _stage_xla
from nhwcodec_tpu.models.device_decode import _synth_level

D = 256
N = 512
SZ = 65536


def _t(x):
    return jnp.swapaxes(x, -2, -1)


def _unmark(process, res256):
    """unmark_res256 (encoder/nhw_encoder.c:183-216): remove the
    16000/12000 sentinels from res256 and nudge the synthesized plane by
    ±1 at the region-mapped positions (strided interleave targets)."""
    v = res256.astype(jnp.int32)
    hi = v > 14000
    marked = v > 10000
    res_clean = (v - jnp.where(hi, 16000, jnp.where(marked, 12000, 0))
                 ).astype(jnp.int16)
    d = jnp.where(marked, jnp.where(hi, 1, -1), 0).astype(jnp.int16)

    # region (r<128, c>=128): target (2(c-128)+1, 2r)
    process = process.at[:, 1:256:2, 0:256:2].add(_t(d[:, :128, 128:]))
    # region (r>=128, c<128): target (2c, 2(r-128)+1)
    process = process.at[:, 0:256:2, 1:256:2].add(_t(d[:, 128:, :128]))
    # region (r>=128, c>=128): target (2(c-128)+1, 2(r-128)+1)
    process = process.at[:, 1:256:2, 1:256:2].add(_t(d[:, 128:, 128:]))
    return process, res_clean


def _ladder_decide(scan, aa, xp=jnp):
    """The nudge decision for one position given scan = pf[e]-r256,
    the adjusted-and-left-augmented neighbour term aa
    (encoder/nhw_encoder.c:218-279)."""
    big = xp.where(scan > 11, -7, xp.where(scan > 7, -4, xp.where(
        scan > 5, -2, xp.where(scan > 4, -1, xp.where(
            scan < -11, 7, xp.where(scan < -7, 4, xp.where(
                scan < -5, 2, xp.where(scan < -4, 1, 0))))))))
    inner = xp.where(
        (scan > 0) & (aa > 0), -1, xp.where(
            (scan < 0) & (aa < 0), 1, xp.where(
                aa >= 5, -2, xp.where(aa <= -5, 2, xp.where(
                    aa >= 4, -1, xp.where(aa <= -4, 1, 0))))))
    small = xp.where(
        (scan >= 4) & (aa >= 1), -1, xp.where(
            (scan <= -4) & (aa <= -1), 1, xp.where(
                (scan == 3) & (aa >= 0), -1, xp.where(
                    (scan == -3) & (aa <= 0), 1, xp.where(
                        xp.abs(aa) >= 3, inner, 0)))))
    return xp.where(big != 0, big,
                    xp.where(xp.abs(scan) > 1, small, 0)).astype(xp.int32)


def _adjust_a(a):
    """The |a|>4 pre-shrink of the right-neighbour delta
    (encoder/nhw_encoder.c:232-246)."""
    pos = jnp.where(a > 11, -7, jnp.where(a > 7, -4,
                                          jnp.where(a > 5, -2, -1)))
    neg = jnp.where(a < -11, 7, jnp.where(a < -7, 4,
                                          jnp.where(a < -5, 2, 1)))
    return jnp.where(jnp.abs(a) > 4, a + jnp.where(a > 0, pos, neg), a)


def _ladder(process, jpeg, res256_clean):
    """requant_scan_ladder as a Jacobi fixpoint (see module docstring).
    process/jpeg: (B,512,512); res256_clean: (B,256,256) sentinel-free.
    Returns the updated (process, jpeg).

    Every neighbour access is a slice: the LL1 scan positions
    e = (cnt>>8<<9)+(cnt&255) are exactly process[:, :256, :256], e+1 is
    process[:, :256, 1:257], and the flat e-1 (which crosses rows like
    the C pointer, landing on the previous row's band tail at col 0) is
    the one-element shift of the flat plane — no gathers."""
    b = process.shape[0]
    p32 = process.astype(jnp.int32)
    r256 = res256_clean.astype(jnp.int32)            # (B,256,256)

    scan0 = p32[:, :D, :D] - r256
    # right neighbour: pf[e+1] - r256[cnt+1] (0 past the last cnt)
    r_next = jnp.concatenate(
        [r256.reshape(b, -1)[:, 1:],
         jnp.zeros((b, 1), jnp.int32)], axis=1).reshape(b, D, D)
    a0 = _adjust_a(p32[:, :D, 1:D + 1] - r_next)
    # fixed part of the left term: pf[e-1] pre-ladder - r256[cnt-1];
    # cnt == 0 reads the zero slack before both arrays
    pf_flat = p32.reshape(b, -1)
    shifted = jnp.concatenate(
        [jnp.zeros((b, 1), jnp.int32), pf_flat[:, :-1]],
        axis=1).reshape(b, N, N)
    r_prev = jnp.concatenate(
        [jnp.zeros((b, 1), jnp.int32),
         r256.reshape(b, -1)[:, :-1]], axis=1).reshape(b, D, D)
    base_left = (shifted[:, :D, :D] - r_prev).reshape(b, -1)
    base_left = base_left.at[:, 0].set(0).reshape(b, D, D)
    # the previous iterate's nudge feeds in only when e-1 is the
    # previous LL1 slot (col >= 1; at col 0 the C pointer reads a band
    # position the ladder never updates)
    m_applies = (jax.lax.broadcasted_iota(jnp.int32, (D, D), 1) >= 1)

    def left_of(m):
        m_prev = jnp.pad(m[:, :, :-1], ((0, 0), (0, 0), (1, 0)))
        return base_left + jnp.where(m_applies, m_prev, 0)

    def cond(state):
        m, changed = state
        return changed

    def body(state):
        m, _ = state
        m2 = _ladder_decide(scan0, a0 + left_of(m))
        return m2, jnp.any(m2 != m)

    m0 = _ladder_decide(scan0, a0 + left_of(jnp.zeros_like(scan0)))
    m, _ = jax.lax.while_loop(cond, body, (m0, jnp.bool_(True)))

    process = process.at[:, :D, :D].set(
        (p32[:, :D, :D] + m).astype(jnp.int16))
    jpeg = jpeg.at[:, :D, :D].set((r256 + m).astype(jnp.int16))
    return process, jpeg


@jax.jit
def requant_tail_device(jpeg, process, res256):
    """The feedback tail after the host's mark + offset(part=1): level-2
    synthesis, unmark, compare ladder, re-analysis — one device program.

    jpeg/process: (B,512,512) int16; res256: (B,256,256) int16 with the
    16000/12000 sentinels still in.  Returns (jpeg', process',
    res256_clean) exactly matching the host sequence
    wavelet_synthesis(256,0) -> unmark_res256 -> requant_scan_ladder ->
    wavelet_analysis(256,1)."""
    with jax.named_scope("nhw.requant.synth"):
        syn = _synth_level(jpeg[:, :D, :D])
    process = process.at[:, :D, :D].set(syn)
    jpeg = jpeg.at[:, :D, :D].set(_t(syn))

    with jax.named_scope("nhw.requant.unmark"):
        process, res_clean = _unmark(process, res256)
    with jax.named_scope("nhw.requant.ladder"):
        process, jpeg = _ladder(process, jpeg, res_clean)

    with jax.named_scope("nhw.requant.reanalysis"):
        j2, p2 = _stage_xla(jpeg[:, :D, :D])
    process = process.at[:, :D, :D].set(p2)
    jpeg = jpeg.at[:, :D, :D].set(j2)
    return jpeg, process, res_clean
