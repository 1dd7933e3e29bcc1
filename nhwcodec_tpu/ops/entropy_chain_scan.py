"""Gather-free codeword-chain extraction for the device Huffman decode.

The gather formulation (ops.entropy_decode_device._codeword_chain_batch)
resolves (symbol, length) at every bit position through a 2^20-entry
peek LUT and extracts the chain with pointer-doubling jump tables —
~24M gathered elements per dense stream.

This module removes every per-position gather:

1. **Threshold cascade instead of the LUT.**  The static code's
   left-aligned 2^20 peek space partitions into only 26 (zone: 28)
   contiguous segments on which the length is constant and the symbol
   is affine in ``peek >> (20 - len)`` (verified exhaustively against
   the LUT — tests/test_entropy_chain_scan.py).  ``len``/``sym`` at
   every position are ~28 vectorized compares + selects, elementwise.
2. **Word-overhang transfer functions.**  A codeword is 2..20 bits, so
   the chain's state at a 32-bit word boundary is the *overhang* of the
   current codeword into the word — one of 20 values.  Each word's
   transfer function T_w : overhang -> overhang is computed by walking
   the word's packed lengths (<= 16 steps, a one-hot select over 8
   packed u32s — elementwise), vectorized over all words x 20 states.
3. **Associative composition.**  T_w compose associatively;
   ``jax.lax.associative_scan`` over the words yields every word's
   entry overhang from bit 0 in log2(W) parallel rounds — the codec's
   "sequence-parallel" transformation (SURVEY.md §5) applied to the
   bit-cursor itself.
4. **Final walk + rank scatter.**  Re-walking each word from its known
   entry overhang emits the start offsets in order; ranks are the
   word-level exclusive cumsum plus the in-word step index, and one
   masked scatter produces the dense symbol array.

Reference behavior: decoder/compress_pixel.c:130-290 (the bit-serial
table1/table2/long-ladder automaton these phases replace).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

PEEK = 20
MAXST = 20          # overhang states: codeword length <= 20
WSTEPS = 16         # max codeword starts in a 32-bit word (min len 2)


@functools.lru_cache(maxsize=2)
def _segments(zone_on: bool):
    """(thresholds, lens, bases) — the affine-segment re-encoding of
    _peek_lut: for the segment with the greatest thr <= peek,
    len = ln[s] and sym = base[s] + (peek >> (20 - len))."""
    from nhwcodec_tpu.ops.entropy_decode_device import _peek_lut

    lut = _peek_lut(zone_on)
    lens = (lut >> 10).astype(np.int64)
    # MAXST/WSTEPS hard-code the code-length range [2, 20] of the static
    # Huffman table (encoder/tree.h:58-140).  If the table (or a filler
    # entry surviving _peek_lut) ever falls outside that range, the
    # word-walk under-steps and corrupts the chain silently — fail loudly
    # here instead.
    assert int(lens.min()) >= 2 and int(lens.max()) <= MAXST, (
        f"Huffman code lengths [{lens.min()}, {lens.max()}] outside the "
        f"[2, {MAXST}] range assumed by MAXST/WSTEPS")
    syms = (lut & 0x3FF).astype(np.int64)
    base = syms - (np.arange(1 << PEEK) >> (PEEK - lens))
    key = (lens << 32) | (base & 0xFFFFFFFF)
    starts = np.concatenate([[0], np.nonzero(np.diff(key))[0] + 1])
    return (starts.astype(np.int64), lens[starts].astype(np.int32),
            base[starts].astype(np.int32))


@functools.lru_cache(maxsize=1)
def _seg_tables():
    """Zone/non-zone segment tables padded to one shape: (2, S) arrays
    so the per-stream zone flag is a cheap row select."""
    t0, l0, b0 = _segments(False)
    t1, l1, b1 = _segments(True)
    s = max(len(t0), len(t1))

    def pad(t, ln, b):
        # repeat the last segment: thresholds are non-decreasing so a
        # duplicated threshold never changes the cascade's outcome
        tt = np.concatenate([t, np.full(s - len(t), t[-1], np.int64)])
        ll = np.concatenate([ln, np.full(s - len(ln), ln[-1], np.int32)])
        bb = np.concatenate([b, np.full(s - len(b), b[-1], np.int32)])
        return tt, ll, bb

    t0, l0, b0 = pad(t0, l0, b0)
    t1, l1, b1 = pad(t1, l1, b1)
    return (np.stack([t0, t1]).astype(np.int32),
            np.stack([l0, l1]), np.stack([b0, b1]))


def _lens_syms(peek, zone):
    """Elementwise (len, sym) from the segment cascade.  peek: (...,)
    int32 in [0, 2^20); zone: broadcastable int32 (0/1)."""
    thr_t, len_t, base_t = (jnp.asarray(a) for a in _seg_tables())
    s = thr_t.shape[1]
    ln = jnp.zeros_like(peek) + len_t[zone, 0]
    base = jnp.zeros_like(peek) + base_t[zone, 0]
    for k in range(1, s):
        m = peek >= thr_t[zone, k]
        ln = jnp.where(m, len_t[zone, k], ln)
        base = jnp.where(m, base_t[zone, k], base)
    sym = base + (peek >> (PEEK - ln))
    return ln, sym


def _walk_word(packed, pos, steps: int):
    """Walk the in-word chain: packed (..., 8) u32 of 8-bit lengths,
    pos (...,) int32 current offset (>= 32 means done).  Yields the
    sequence of positions; returns (positions list, exit offset)."""
    out = []
    for _ in range(steps):
        out.append(pos)
        q = pos >> 2
        sh = ((pos & 3) << 3).astype(jnp.uint32)
        ln = jnp.zeros_like(pos)
        for j in range(8):
            lane = (packed[..., j] >> sh).astype(jnp.int32) & 0xFF
            ln = jnp.where(q == j, lane, ln)
        pos = jnp.where(pos < 32, pos + ln, pos)
    return out, pos


@functools.partial(jax.jit, static_argnames=("s_max",))
def chain_starts_batch(words: jnp.ndarray, nbits: jnp.ndarray,
                       zone: jnp.ndarray, s_max: int):
    """Gather-free batched codeword-chain extraction.

    words: (B, W) uint32 packed big-endian code words (zero-padded);
    nbits: (B,) real bit counts; zone: (B,) int32 zone mode.  Returns
    (syms (B, s_max) int32, counts (B,) int32) with the same semantics
    as entropy_decode_device._codeword_chain_batch: syms[s] is the s-th
    codeword of the chain from bit 0 (zero-padding decodes as the
    all-zeros-prefix code), counts = number of chain starts < nbits.
    """
    b, w = words.shape
    zone2 = zone[:, None].astype(jnp.int32)

    # per-offset peeks: peek at bit 32*j + k reads words j, j+1; one
    # stacked (B, 32, W) array so the segment cascade traces once
    nxt = jnp.concatenate([words[:, 1:], jnp.zeros((b, 1), jnp.uint32)],
                          axis=1)
    pks = [words >> jnp.uint32(32 - PEEK)]
    for k in range(1, 32):
        pks.append(((words << jnp.uint32(k)) | (nxt >> jnp.uint32(32 - k)))
                   >> jnp.uint32(32 - PEEK))
    peek = jnp.stack(pks, axis=1).astype(jnp.int32) & ((1 << PEEK) - 1)
    lens32, syms32 = _lens_syms(peek, zone2[:, :, None])  # (B, 32, W)

    # pack the 32 per-offset lengths into 8 u32 lanes per word
    lu = lens32.astype(jnp.uint32)
    packed = jnp.stack(
        [(lu[:, 4 * j] | (lu[:, 4 * j + 1] << 8)
          | (lu[:, 4 * j + 2] << 16) | (lu[:, 4 * j + 3] << 24))
         for j in range(8)], axis=-1)            # (B, W, 8)

    # word transfer functions over the 20 overhang states
    pos0 = jnp.broadcast_to(
        jnp.arange(MAXST, dtype=jnp.int32)[None, :, None], (b, MAXST, w))
    _, exit_pos = _walk_word(packed[:, None, :, :], pos0, WSTEPS)
    t_states = exit_pos - 32                     # (B, MAXST, W) in [0,20)

    # pack each word's 20-state transfer into 5 u32s of 8-bit fields
    def pack_state(lst):
        outs = []
        for j in range(5):
            v = (lst[4 * j].astype(jnp.uint32)
                 | (lst[4 * j + 1].astype(jnp.uint32) << 8)
                 | (lst[4 * j + 2].astype(jnp.uint32) << 16)
                 | (lst[4 * j + 3].astype(jnp.uint32) << 24))
            outs.append(v)
        return tuple(outs)

    def unpack_state(tp, d: int):
        return (tp[d >> 2] >> jnp.uint32((d & 3) << 3)).astype(
            jnp.int32) & 0xFF

    def compose(g, f):
        """(f after g): out[d] = f[g[d]] — one-hot over the 20 fields."""
        fv = [unpack_state(f, j) for j in range(MAXST)]
        outs = []
        for d in range(MAXST):
            gd = unpack_state(g, d)
            x = jnp.zeros_like(gd)
            for j in range(MAXST):
                x = jnp.where(gd == j, fv[j], x)
            outs.append(x)
        return pack_state(outs)

    tw = pack_state([t_states[:, i] for i in range(MAXST)])
    pref = jax.lax.associative_scan(compose, tw, axis=-1)
    # entry overhang of word w = prefix_{w-1} applied to state 0
    ent0 = unpack_state(pref, 0)                 # (B, W): exit of prefix
    entry = jnp.concatenate(
        [jnp.zeros((b, 1), jnp.int32), ent0[:, :-1]], axis=1)

    # final walk from the known entry; emit start offsets in order
    positions, _ = _walk_word(packed, entry, WSTEPS)
    pos_s = jnp.stack(positions, axis=1)         # (B, WSTEPS, W)
    valid = pos_s < 32
    gpos = (jnp.arange(w, dtype=jnp.int32)[None, None, :] * 32) + pos_s
    counts = jnp.sum(valid & (gpos < nbits[:, None, None]),
                     axis=(1, 2)).astype(jnp.int32)

    # symbol at each start: one-hot over the 32 per-offset sym arrays
    sym_s = jnp.zeros_like(pos_s)
    for k in range(32):
        sym_s = jnp.where(pos_s == k, syms32[:, k][:, None, :], sym_s)

    # rank = words' exclusive start-count prefix + step index
    cnt_w = jnp.sum(valid, axis=1).astype(jnp.int32)        # (B, W)
    prefix = jnp.cumsum(cnt_w, axis=1) - cnt_w
    rank = prefix[:, None, :] + jnp.arange(
        WSTEPS, dtype=jnp.int32)[None, :, None]
    row = jnp.arange(b, dtype=jnp.int32)[:, None, None] * (s_max + 1)
    # distinct OOB sentinels -> unique_indices: without the promise
    # XLA may serialize the multi-million-update scatter
    seq = jnp.arange(rank.size, dtype=jnp.int32).reshape(rank.shape)
    flat_rank = jnp.where(valid & (rank < s_max), rank + row,
                          b * (s_max + 1) + seq)
    out = jnp.zeros(b * (s_max + 1), jnp.int32)
    out = out.at[flat_rank.reshape(-1)].set(
        sym_s.reshape(-1), mode="drop", unique_indices=True)
    syms = out.reshape(b, s_max + 1)[:, :s_max]
    return syms, counts
