"""Device formulation of the static-Huffman bitstream decode.

The reference decodes the stream with a serial bit-cursor automaton
(decoder/compress_pixel.c:130-437).  The device formulation splits that
into three phases, two of which are fully parallel:

1. **Peek-LUT codeword resolution** — the code is static (at most 20
   bits, tables.HUFFMAN_CODES/LENS, plus the 15-bit zone escape), so a
   2^20-entry LUT maps the 20-bit peek at *every* bit position to
   (symbol, length) in one gather.  This replaces the reference's
   table1/table2/long-ladder automaton (decoder/compress_pixel.c:
   130-290) — the ladder is just an algorithmic encoding of the same
   prefix code, proven equal in tests/test_entropy_decode_device.py.
2. **Pointer-doubling chain extraction** — ``next[p] = p + len[p]``
   defines the codeword chain from bit 0; ``next^(2^k)`` jump tables
   (log₂ S levels of parallel gathers) extract all S codeword start
   positions at once, with no sequential bit cursor.
3. **Symbol automaton** — Y runs a ``lax.scan`` whose carry is the
   cursor, the run/select mode counters and a 5-value history window
   (the run-reinsertion rules of decoder/compress_pixel.c:296-341
   consult the last 5 decoded outputs); each step emits ≤2 (position,
   value) writes which are scattered afterwards.  UV has no history
   rules, so it collapses to an exclusive prefix sum over the cursor
   advances plus one masked scatter — fully parallel.

Bit-exact against ops.entropy.decode_y/decode_uv on real streams.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from nhwcodec_tpu import tables as T

PEEK = 20  # max code length (HUFFMAN_LENS.max() == 20; zone escape 15)


# ------------------------------------------------------------------
# host-side static tables (built once, cached)

@functools.lru_cache(maxsize=2)
def _peek_lut(zone_on: bool) -> np.ndarray:
    """peek20 -> sym | (len << 10).

    The automaton maps HUFFMAN_CODES[j] -> j for all j in 0..289; with
    zone on, j >= ZONE1 shifts by UNZONE1 (decoder/compress_pixel.c:
    284-287) and the 9-bit 0x1 prefix opens the 15-bit zone escape
    (:141-158), which shadows everything in its range (the automaton
    checks it first).  Unreachable patterns get len=1 filler so the
    jump chain stays monotone on padding.
    """
    lut = np.full(1 << PEEK, 0 | (1 << 10), np.int32)
    codes = T.HUFFMAN_CODES.astype(np.int64)
    lens = T.HUFFMAN_LENS.astype(np.int64)
    for j in range(290):
        c, ln = int(codes[j]), int(lens[j])
        sym = j + T.UNZONE1 if (zone_on and j >= T.ZONE1) else j
        lo = c << (PEEK - ln)
        lut[lo: lo + (1 << (PEEK - ln))] = sym | (ln << 10)
    if zone_on:
        # escape: 000000001 kkkkkk ...... -> sym 110+k, len 15
        base = 1 << (PEEK - 9)
        for k in range(64):
            lo = base + (k << (PEEK - 15))
            lut[lo: lo + (1 << (PEEK - 15))] = (T.ZONE1 + k) | (15 << 10)
    return lut


@functools.lru_cache(maxsize=1)
def _y_word_tables() -> tuple[np.ndarray, ...]:
    """Per-word static behavior of the Y automaton's non-run cases
    (decoder/compress_pixel.c:343-437): value written at e, optional
    second value at e+4, cursor advance, mem2 set."""
    val1 = np.zeros(256, np.int32)
    val2 = np.zeros(256, np.int32)
    has2 = np.zeros(256, np.int32)
    adv = np.ones(256, np.int32)
    mem2 = np.zeros(256, np.int32)
    extra = np.concatenate([T.EXTRA_TABLE.astype(np.int32), [0]])
    for w in range(256):
        if w == 136:
            val1[w], mem2[w] = 11, 1
        elif w == 120:
            val1[w], mem2[w] = -11, 1
        elif w in (132, 133, 134, 135):
            val1[w] = 11 if w in (132, 133) else -11
            val2[w] = 11 if w in (132, 134) else -11
            has2[w], adv[w] = 1, 5
        elif w == 127:
            val1[w] = 1008
        elif w == 129:
            val1[w] = 1009
        elif w == 125:
            val1[w] = 1006
        elif w == 126:
            val1[w] = 1007
        elif w == 121:
            val1[w] = 1010
        elif w == 122:
            val1[w] = 1011
        elif w == 124:
            val1[w] = 11
        elif w == 123:
            val1[w] = -11
        elif w < T.ZONE1 and extra[w]:
            x = int(extra[w])
            val1[w] = (T.WVLT_ENERGY_NHW + (x << 3) if x > 0
                       else (x << 3) - T.WVLT_ENERGY_NHW)
        elif w > 0x80:
            val1[w] = w - T.INV_QUANT1
        else:
            val1[w] = w - T.INV_QUANT2
    return val1, val2, has2, adv, mem2


@functools.lru_cache(maxsize=1)
def _y_word_tables_packed() -> np.ndarray:
    """The five per-word tables packed into ONE int32 LUT so the hot
    (B, s_len) per-symbol resolution costs one gather instead of five
    (gathers dominate the xs-prep phase).  Layout: val1+2048 in
    bits 0..11 (val1 spans [-275, 1011]), val2 code in 12..13
    (0 -> 0, 1 -> +11, 2 -> -11), has2 bit 14, adv==5 bit 15, mem2
    bit 16."""
    val1, val2, has2, adv, mem2 = _y_word_tables()
    assert val1.min() >= -2048 and val1.max() < 2048
    v2code = np.where(val2 == 0, 0, np.where(val2 > 0, 1, 2))
    return ((val1 + 2048) | (v2code << 12) | (has2 << 14)
            | ((adv == 5).astype(np.int32) << 15)
            | (mem2 << 16)).astype(np.int32)


def _unpack_word_fields(pk):
    """Inverse of _y_word_tables_packed, elementwise on device."""
    wv1 = (pk & 0xFFF) - 2048
    v2c = (pk >> 12) & 3
    wv2 = jnp.where(v2c == 1, 11, jnp.where(v2c == 2, -11, 0))
    whas2 = (pk >> 14) & 1
    wadv = jnp.where(((pk >> 15) & 1) == 1, 5, 1)
    wmem2 = (pk >> 16) & 1
    return wv1, wv2, whas2, wadv, wmem2


@functools.lru_cache(maxsize=1)
def _uv_word_table() -> np.ndarray:
    """UV non-run value per word (decoder/compress_pixel.c:575-637)."""
    val = np.zeros(256, np.int32)
    extra = np.concatenate([T.EXTRA_TABLE.astype(np.int32), [0]])
    for w in range(256):
        if w < T.ZONE1:
            x = int(extra[w])
            if x:
                val[w] = (T.WVLT_ENERGY_NHW + (x << 3) if x > 0
                          else (x << 3) - T.WVLT_ENERGY_NHW)
            else:
                val[w] = w - T.INV_QUANT2
        elif w == 124:
            val[w] = 5005
        elif w == 126:
            val[w] = 5006
        elif w == 122:
            val[w] = 5003
        elif w == 130:
            val[w] = 5004
        elif w > 0x80:
            val[w] = w - T.INV_QUANT1
        else:
            val[w] = w - T.INV_QUANT2
    return val


# ------------------------------------------------------------------
# phase 1+2: bit-parallel codeword chain

@functools.partial(jax.jit, static_argnames=("s_max",))
def _codeword_chain_batch(words: jnp.ndarray, nbits: jnp.ndarray,
                          zone: jnp.ndarray, s_max: int
                          ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """words: (B, W) uint32 packed code words (zero-padded bucket) —
    the 32x-smaller transfer format; bits expand on device.  zone:
    (B,) int32 per-stream zone mode (a dynamic LUT select, so one
    compiled program serves both modes).  Returns (syms (B, s_max),
    counts (B,)): the first ``s_max`` codewords of each chain from bit
    0 and how many start before ``nbits``."""
    # every gather below is 1-D with 1-D indices: rows are flattened
    # into one index space (row r occupies [r*n, (r+1)*n)); the chain never
    # crosses rows because next() is clamped inside the row before the
    # row offset is added
    b, w = words.shape
    n = w * 32
    i = jnp.arange(n, dtype=jnp.int32)
    bits = ((words[:, i >> 5] >> (31 - (i & 31))) & 1).astype(jnp.int32)
    bits = jnp.concatenate([bits, jnp.zeros((b, PEEK), jnp.int32)], axis=1)

    peek = jnp.zeros((b, n), jnp.int32)
    for k in range(PEEK):
        peek = (peek << 1) | bits[:, k: k + n]
    lut2 = jnp.concatenate([jnp.asarray(_peek_lut(False)),
                            jnp.asarray(_peek_lut(True))])
    lut_ix = (peek + (zone[:, None] << PEEK)).reshape(-1)
    entry = lut2[lut_ix]
    lens = entry >> 10
    syms_f = entry & 0x3FF

    row0 = (jnp.arange(b, dtype=jnp.int32) * n)[:, None]
    in_row = jnp.minimum(jnp.broadcast_to(i[None, :], (b, n)).reshape(-1)
                         + lens, n - 1)
    nxt = in_row + jnp.broadcast_to(row0, (b, n)).reshape(-1)
    levels = max(1, (s_max - 1).bit_length())
    jumps = [nxt]
    for _ in range(levels - 1):
        jumps.append(jumps[-1][jumps[-1]])

    s = jnp.broadcast_to(jnp.arange(s_max, dtype=jnp.int32)[None, :],
                         (b, s_max)).reshape(-1)
    pos = jnp.broadcast_to(row0, (b, s_max)).reshape(-1)
    for k in range(levels):
        pos = jnp.where((s >> k) & 1, jumps[k][pos], pos)
    pos2 = pos.reshape(b, s_max)
    return (syms_f[pos].reshape(b, s_max),
            jnp.sum(pos2 - row0 < nbits[:, None], axis=1))


def _codeword_chain_words(words, nbits, s_max: int, zone_on: bool):
    """Single-stream wrapper over the batched chain."""
    syms, count = _codeword_chain_batch(
        words[None], jnp.asarray([nbits], jnp.int32),
        jnp.asarray([1 if zone_on else 0], jnp.int32), s_max)
    return syms[0], count[0]


def _bucket(n: int, lo: int = 64) -> int:
    """Smallest quarter-octave bucket >= n, a multiple of 64: bounds
    the number of compiled shape classes (<= 4 per octave) while
    capping padding waste at 25% — pow2 bucketing wasted up to 2x
    (e.g. 77,659 runs -> 131,072; now 81,920)."""
    if n <= lo:
        return lo
    k = (n - 1).bit_length() - 3   # octave base 2^(k+2); quarter = 2^k
    step = max(1 << k, 64)         # multiple of 64: k_chunks divides
    return ((n + step - 1) // step) * step


def _chain_dispatch(words2d, nbits, zone, s_max: int):
    """Backend-dispatched chain extraction: the gather-free segment
    cascade (ops.entropy_chain_scan) on accelerators, the peek-LUT +
    pointer-doubling formulation on the CPU backend.  The cascade's
    op-heavy graph compiles slowly everywhere (tens of minutes on
    XLA:CPU at real shapes, ~100 s per shape on an H100, against ~1.5 s
    for the LUT form) but runs faster on the GPU (0.65x the LUT form's
    device time at 32 streams, PERF.md); compiles persist in the
    compilation cache.  Bit-equal either way
    (tests/test_entropy_chain_scan.py)."""
    if jax.default_backend() == "cpu":
        return _codeword_chain_batch(words2d, nbits, zone, s_max)
    from nhwcodec_tpu.ops import entropy_chain_scan as ecs

    return ecs.chain_starts_batch(words2d, nbits, zone, s_max)


@jax.jit
def _run_count(syms, vals, count):
    """Number of run symbols among the real (pre-park) chain — sizes the
    runs-only automaton's scan length."""
    nv = vals.shape[0]
    word = vals[jnp.minimum(syms, nv - 1)]
    live = jnp.arange(syms.shape[0], dtype=jnp.int32) <= count
    return jnp.sum((word == 0x80) & live)


@jax.jit
def _run_count_batch(syms, vals, counts):
    """Per-stream run-symbol counts in ONE launch (not one per stream);
    flat 1-D gather over a row-offset index space."""
    b, nv = vals.shape
    rowV = (jnp.arange(b, dtype=jnp.int32) * nv)[:, None]
    sym_c = jnp.minimum(syms, nv - 1)
    word = vals.reshape(-1)[(sym_c + rowV).reshape(-1)].reshape(
        syms.shape)
    live = (jnp.arange(syms.shape[1], dtype=jnp.int32)[None, :]
            <= counts[:, None])
    return jnp.sum((word == 0x80) & live, axis=1)


# ------------------------------------------------------------------
# phase 3, Y: the run/select automaton as a scan

@functools.partial(jax.jit, static_argnames=("p1",))
def _y_automaton(syms, vals, rles, sel1, sel2, p1: int):
    """Scan the Y symbol sequence into the int16 plane
    (decoder/compress_pixel.c:296-437).  Carry: cursor e, run-mode
    counters (mem/mem2/nhw_ac1/run_over), select cursors (t/t2) and the
    last-5-outputs window the reinsertion rules consult.

    All per-symbol table gathers are hoisted out of the scan (one
    vectorized gather pass); the scan body is pure scalar arithmetic
    plus the two data-dependent select-bit gathers."""
    val1_t, val2_t, has2_t, adv_t, mem2_t = (jnp.asarray(a)
                                             for a in _y_word_tables())
    nv = vals.shape[0]
    sym_c = jnp.minimum(syms, nv - 1)
    word_x = vals[sym_c]
    rle_x = rles[sym_c]
    xs = (word_x == 0x80, rle_x, val1_t[word_x], val2_t[word_x],
          has2_t[word_x], adv_t[word_x], mem2_t[word_x])

    def step(carry, x):
        e, mem, mem2, ac1, run_over, w1, w2, w3, w4, w5, done = carry
        is_run, rle, wv1, wv2, whas2, wadv, wmem2 = x

        # ---- run branch (word == 0x80): reinsertion + zero run
        mem_r = mem + 1
        room = (e + rle - 257) >= run_over
        ins2 = (mem2 == 1) & (
            ((e >= 5) & (w2 == 0) & (w3 == 0) & (w4 == 0) & (w5 == 0))
            | ((rle >= 4) & (w2 == 0)))
        c2 = ((e >= 4) & (w1 == 0) & (w2 == 0) & (w3 == 0) & (w4 == 0)
              & room) | ((rle >= 4) & (e > 0) & (w1 == 0) & room)
        insB = (mem2 != 1) & (mem_r == 2) & (ac1 == 0) & c2
        insC = ((mem2 != 1) & ~((mem_r == 2) & (ac1 == 0))
                & (rle >= 4) & (e > 0) & (w1 == 0) & (ac1 == 0) & room)
        ins1 = insB | insC
        ins = ins1 | ins2
        # the automaton's own state only consults inserted values via
        # ==0 checks, and both select outcomes (+-11) are nonzero — so
        # carry a placeholder and resolve the sign after the scan from
        # the select-bit ranks (cumsum of the insert events)
        ins_val = jnp.int32(11)
        e_ins = e + ins.astype(jnp.int32)
        # window after a possible insert, then after rle zeros shift in
        iw1 = jnp.where(ins, ins_val, w1)
        iw2 = jnp.where(ins, w1, w2)
        iw3 = jnp.where(ins, w2, w3)
        iw4 = jnp.where(ins, w3, w4)
        iw5 = jnp.where(ins, w4, w5)
        is254 = rle == 254
        run_mem = jnp.where(is254, 0, jnp.where(ins1, 1, mem_r))
        run_ac1 = is254.astype(jnp.int32)
        run_run_over = jnp.where(is254, e_ins, run_over)
        run_e = e_ins + rle
        z = jnp.int32(0)
        rw1 = jnp.where(rle >= 1, z, iw1)
        rw2 = jnp.where(rle >= 2, z, jnp.where(rle >= 1, iw1, iw2))
        rw3 = jnp.where(rle >= 3, z,
                        jnp.where(rle >= 2, iw1,
                                  jnp.where(rle >= 1, iw2, iw3)))
        rw4 = jnp.where(rle >= 4, z,
                        jnp.where(rle >= 3, iw1,
                                  jnp.where(rle >= 2, iw2,
                                            jnp.where(rle >= 1, iw3, iw4))))
        rw5 = jnp.where(rle >= 5, z,
                        jnp.where(rle >= 4, iw1,
                                  jnp.where(rle >= 3, iw2,
                                            jnp.where(rle >= 2, iw3,
                                                      jnp.where(rle >= 1,
                                                                iw4, iw5)))))
        # ---- literal branch: static per-word behavior
        adv5 = wadv == 5
        lit_e = e + wadv
        lw1 = jnp.where(adv5, wv2, wv1)
        lw2 = jnp.where(adv5, z, w1)
        lw3 = jnp.where(adv5, z, w2)
        lw4 = jnp.where(adv5, z, w3)
        lw5 = jnp.where(adv5, wv1, w4)
        lit_p2 = jnp.where(whas2 == 1, e + 4, -1)

        # ---- merge
        act = jnp.logical_not(done)
        sel_run = is_run & act
        sel_lit = (~is_run) & act
        e_new = jnp.where(sel_run, run_e, jnp.where(sel_lit, lit_e, e))
        mem_new = jnp.where(sel_run, run_mem, jnp.where(sel_lit, 0, mem))
        mem2_new = jnp.where(sel_run, jnp.where(mem2 == 1, 0, mem2),
                             jnp.where(sel_lit, wmem2, mem2))
        ac1_new = jnp.where(sel_run, run_ac1, jnp.where(sel_lit, 0, ac1))
        ro_new = jnp.where(sel_run, run_run_over, run_over)
        n1 = jnp.where(sel_run, rw1, jnp.where(sel_lit, lw1, w1))
        n2 = jnp.where(sel_run, rw2, jnp.where(sel_lit, lw2, w2))
        n3 = jnp.where(sel_run, rw3, jnp.where(sel_lit, lw3, w3))
        n4 = jnp.where(sel_run, rw4, jnp.where(sel_lit, lw4, w4))
        n5 = jnp.where(sel_run, rw5, jnp.where(sel_lit, lw5, w5))
        p_a = jnp.where(sel_run, jnp.where(ins, e, -1),
                        jnp.where(sel_lit, e, -1))
        ev1 = sel_run & ins1
        ev2 = sel_run & ins2
        p_b = jnp.where(sel_lit, lit_p2, -1)
        done_new = done | (e_new >= p1 - 1)
        return ((e_new, mem_new, mem2_new, ac1_new, ro_new,
                 n1, n2, n3, n4, n5, done_new),
                (p_a, ev1, ev2, p_b))

    zi = jnp.int32(0)
    carry0 = (zi, zi, zi, zi, jnp.int32(-257),
              zi, zi, zi, zi, zi, jnp.bool_(False))
    # unroll amortizes per-step overhead on an accelerator (3x faster
    # at unroll 8 than 2 on an H100, PERF.md); on CPU it only slows
    # compilation and execution
    unroll = 2 if jax.default_backend() == "cpu" else 8
    _, (pa, ev1, ev2, pb) = jax.lax.scan(step, carry0, xs, unroll=unroll)

    # resolve inserted values from the select bitstreams, vectorized
    r1 = jnp.cumsum(ev1.astype(jnp.int32)) - 1
    r2 = jnp.cumsum(ev2.astype(jnp.int32)) - 1
    sv1 = jnp.where(sel1[jnp.minimum(jnp.maximum(r1, 0),
                                     sel1.shape[0] - 1)] == 0, 11, -11)
    sv2 = jnp.where(sel2[jnp.minimum(jnp.maximum(r2, 0),
                                     sel2.shape[0] - 1)] == 0, -11, 11)
    va = jnp.where(ev2, sv2, jnp.where(ev1, sv1, xs[2]))
    vb = xs[3]

    out = jnp.zeros(p1 + 512, jnp.int16)
    big = p1 + 512
    # distinct OOB sentinels -> unique_indices (see _runs_emit_batch)
    seqS = big + jnp.arange(pa.shape[0], dtype=jnp.int32)
    out = out.at[jnp.where(pa < 0, seqS, pa)].set(
        va.astype(jnp.int16), mode="drop", unique_indices=True)
    out = out.at[jnp.where(pb < 0, seqS, pb)].set(
        vb.astype(jnp.int16), mode="drop", unique_indices=True)
    return out[:p1]


# ------------------------------------------------------------------
# phase 3, UV: prefix-sum + masked scatter (no sequential state)

@functools.partial(jax.jit, static_argnames=("p1",))
def _uv_scatter(syms, vals, rles, p1: int):
    val_t = jnp.asarray(_uv_word_table())
    nv = vals.shape[0]
    sym_c = jnp.minimum(syms, nv - 1)
    word = vals[sym_c]
    rle = rles[sym_c]
    is_run = word == 0x80
    adv = jnp.where(is_run, rle, 1)
    e_start = jnp.concatenate([jnp.zeros(1, jnp.int32),
                               jnp.cumsum(adv)[:-1]])
    # the host loop processes symbol s iff the cursor before it is
    # < p1-1 (decoder/compress_pixel.c:639-641's break placement)
    live = (e_start < p1 - 1) & (~is_run)
    big = p1 + 512
    out = jnp.zeros(p1 + 512, jnp.int16)
    # distinct OOB sentinels -> unique_indices (see _runs_emit_batch)
    seqS = big + jnp.arange(e_start.shape[0], dtype=jnp.int32)
    out = out.at[jnp.where(live, e_start, seqS)].set(
        val_t[word].astype(jnp.int16), mode="drop", unique_indices=True)
    return out[: 2 * T.IM_SIZE]


# ------------------------------------------------------------------
# public API (mirrors ops.entropy.decode_y / decode_uv)

def _words_device(packet: np.ndarray) -> tuple[jnp.ndarray, int]:
    """Upload the packed u32 code words (bucketed) — bits expand on
    device, so the transfer is 32x smaller than a bit array."""
    nw = 1 << max(7, int(packet.size).bit_length())  # bucket for jit
    out = np.zeros(nw, np.uint32)
    out[:packet.size] = packet
    return jnp.asarray(out), packet.size * 32


def _book_device(vals: list, rles: list) -> tuple[jnp.ndarray, jnp.ndarray]:
    n = 1 << max(6, (len(vals) - 1).bit_length() if vals else 1)
    v = np.zeros(n, np.int32)
    r = np.zeros(n, np.int32)
    v[:len(vals)] = vals
    r[:len(rles)] = rles
    return jnp.asarray(v), jnp.asarray(r)


def _check_book(vals: list, rles: list, kind: str) -> None:
    """Host-side stream-invariant validation before device dispatch.

    The emit scatters promise ``unique_indices=True``, which is sound
    only because every decoded symbol advances the output cursor by
    >= 1 (literals advance 1 or 5, runs advance their rle) — so all
    scatter positions are provably distinct.  A malformed .nhw whose
    codebook carries a run word with rle == 0 would break that promise
    and turn bounded-wrong decode into undefined scatter results; reject
    it here.  Valid encoder output never emits rle < 1
    (encoder/compress_pixel.c:280-361 counts runs from 1)."""
    if any(r < 1 for r in rles):
        raise ValueError(
            f"malformed .nhw: {kind} codebook contains a run word with "
            "rle < 1 (device decode requires cursor-advancing symbols)")
    if any(r > 255 for r in rles):
        # the format's run lengths are single stream bytes (encoder
        # caps runs at 255, encoder/nhw_encoder.c:2220-2252); the
        # device packings carry rle in 8-9 bits on that invariant
        raise ValueError(
            f"malformed .nhw: {kind} codebook run length > 255")


def decode_y_device(packet1: np.ndarray, tree1: np.ndarray,
                    select_word1: np.ndarray, select_word2: np.ndarray,
                    res_high: int, p1: int = 4 * T.IM_SIZE,
                    use_runs: bool = False,
                    automaton: str | None = None) -> np.ndarray:
    """Device decode of the Y symbol plane; bit-exact vs entropy.decode_y.

    ``use_runs``: route phase 3 through the runs-only automaton
    (_y_automaton_runs) — the 2-3x shorter serial core.  Off by
    default: its first XLA compile of the largest (2^17-run) stream
    shapes is slow."""
    from nhwcodec_tpu.ops import entropy

    vals, rles = entropy.build_y_book(tree1)
    _check_book(vals, rles, "Y")
    vd, rd = _book_device(vals, rles)
    words, nbits = _words_device(packet1)
    s_max = min(p1, max(64, nbits // 2 + 2))
    s_max = 1 << (s_max - 1).bit_length()
    zone_on = res_high < 4
    symsB, countB = _chain_dispatch(
        words[None], jnp.asarray([nbits], jnp.int32),
        jnp.asarray([1 if zone_on else 0], jnp.int32), s_max)
    syms, count = symsB[0], countB[0]
    # one tiny sync to trim the automaton scan to the real codeword
    # count (the chain parks at the last bit once the stream runs out)
    # and to size the runs-only scan (any parked-tail runs beyond r_max
    # are dropped by nonzero — they sit past the output cutoff)
    rc = _run_count(syms, vd, count)
    n_real, n_runs = (int(v) for v in np.asarray(jnp.stack([count, rc])))
    n_real += 1
    s_trim = 1 << max(6, (min(n_real, s_max) - 1).bit_length())
    syms = syms[:s_trim]

    def pad_bits(b):
        x = np.unpackbits(np.ascontiguousarray(b, np.uint8))
        n = 1 << max(6, int(x.size - 1).bit_length() if x.size else 6)
        o = np.zeros(n, np.uint8)
        o[:x.size] = x
        return jnp.asarray(o)

    if automaton is None:
        automaton = "runs" if use_runs else "full"
    if automaton == "chunked":
        r_max = 1 << max(6, (max(n_runs, 1) - 1).bit_length())
        out, iters = _y_automaton_runs_chunked(
            syms, vd, rd, pad_bits(select_word1),
            pad_bits(select_word2), p1, r_max)
        if int(iters) > min(64, r_max):  # non-converged: sequential fallback
            out = _y_automaton_runs(syms, vd, rd, pad_bits(select_word1),
                                    pad_bits(select_word2), p1,
                                    1 << max(4, (max(n_runs, 1)
                                                 - 1).bit_length()))
    elif automaton == "runs":
        r_max = 1 << max(4, (max(n_runs, 1) - 1).bit_length())
        out = _y_automaton_runs(syms, vd, rd, pad_bits(select_word1),
                                pad_bits(select_word2), p1, r_max)
    else:
        out = _y_automaton(syms, vd, rd, pad_bits(select_word1),
                           pad_bits(select_word2), p1)
    return np.asarray(out)


# ------------------------------------------------------------------
# phase 3, Y, runs-only: shrink the serial core to the run symbols
#
# The automaton's state (mem/mem2/ac1/run_over and the last-5-outputs
# window) changes in a data-dependent way ONLY at run symbols: every
# literal resets mem/ac1, overwrites mem2 from a static per-word table,
# and shifts statically-known values into the window — and since every
# literal emission is nonzero and the reinsertion rules consult the
# window only through ==0 tests, a literal segment's whole effect is a
# tiny monoid (5 window bits + clipped count) computable with one
# segmented associative scan.  The sequential scan then walks ONLY the
# runs (33-54% of the symbols on real streams), composing each run's
# incoming window from the carried post-run window and the segment
# summary.  Literal output positions are a static advance prefix plus
# the insert count carried out of the run scan.


def _runs_xs(syms, vals, rles, p1: int, r_max: int):
    """Shared preprocessing of the runs-only automaton: per-run input
    tuples (everything statically derivable from the symbol sequence)
    plus the literal-emission tables used by the final scatter."""
    val1_t, val2_t, has2_t, adv_t, mem2_t = (jnp.asarray(a)
                                             for a in _y_word_tables())
    nv = vals.shape[0]
    s_len = syms.shape[0]
    sym_c = jnp.minimum(syms, nv - 1)
    word = vals[sym_c]
    rle_x = rles[sym_c]
    is_run = word == 0x80
    wv1 = val1_t[word]
    wv2 = val2_t[word]
    whas2 = has2_t[word]
    wadv = adv_t[word]
    wmem2 = mem2_t[word]

    adv_static = jnp.where(is_run, rle_x, wadv)
    base_e = jnp.cumsum(adv_static) - adv_static   # e before symbol i
    runs_before = jnp.cumsum(is_run.astype(jnp.int32)) - is_run

    # segmented associative scan of the literal window monoid
    lit_mask = jnp.where(wadv == 5, 17, 1)         # [1,0,0,0,1] / [1]
    lit_cnt = jnp.where(wadv == 5, 5, 1)
    m0 = jnp.where(is_run, 0, lit_mask).astype(jnp.int32)
    c0 = jnp.where(is_run, 0, lit_cnt).astype(jnp.int32)
    r0 = is_run.astype(jnp.int32)

    def comb(a, b):
        am, ac, ar = a
        bm, bc, br = b
        keep = br == 1
        m = jnp.where(keep, bm,
                      (bm | (am << jnp.minimum(bc, 5))) & 31)
        c = jnp.where(keep, bc, jnp.minimum(ac + bc, 5))
        return m, c, jnp.maximum(ar, br)

    seg_mask_all, seg_cnt_all, _ = jax.lax.associative_scan(
        comb, (m0, c0, r0))

    # gather per-run inputs (padded rows are no-ops)
    run_idx = jnp.nonzero(is_run, size=r_max, fill_value=s_len)[0]
    vld = run_idx < s_len
    ri = jnp.minimum(run_idx, s_len - 1)
    rle_r = jnp.where(vld, rle_x[ri], 0)
    e_base_r = jnp.where(vld, base_e[ri], jnp.int32(p1 + (1 << 20)))
    prev = jnp.maximum(ri - 1, 0)
    has_prev = (run_idx > 0) & vld
    segm = jnp.where(has_prev, seg_mask_all[prev], 0)
    segc = jnp.where(has_prev, jnp.minimum(seg_cnt_all[prev], 5), 0)
    prev_run = has_prev & is_run[prev]
    prev_lit_mem2 = jnp.where(has_prev & ~is_run[prev], wmem2[prev], 0)

    xs = (rle_r, e_base_r, segm, segc,
          prev_run, prev_lit_mem2, vld)
    lits = (is_run, base_e, runs_before, wv1, wv2, whas2)
    return xs, lits


def _runs_step(p1: int):
    """The runs-only automaton transition, shaped for lax.scan (works
    with scalar carries or (K,)-chunk-vector carries alike)."""

    def step(carry, x):
        ins_cnt, mem_c, mem2_c, ac1_c, run_over, win_c = carry
        rle, e_base, sm, sc, prun, plmem2, valid = x
        e_in = e_base + ins_cnt
        act = valid & (e_in < p1 - 1)

        mem_in = jnp.where(prun, mem_c, 0)
        mem2_in = jnp.where(prun, mem2_c, plmem2)
        ac1_in = jnp.where(prun, ac1_c, 0)
        win_in = (sm | (win_c << sc)) & 31

        def z(k):       # out[e-k] == 0
            return ((win_in >> (k - 1)) & 1) == 0

        mem_r = mem_in + 1
        room = (e_in + rle - 257) >= run_over
        ins2 = (mem2_in == 1) & (
            ((e_in >= 5) & z(2) & z(3) & z(4) & z(5))
            | ((rle >= 4) & (e_in >= 2) & z(2)))
        first2 = (mem_r == 2) & (ac1_in == 0)
        cB = ((e_in >= 4) & z(1) & z(2) & z(3) & z(4) & room) \
            | ((rle >= 4) & (e_in > 0) & z(1) & room)
        insB = (mem2_in != 1) & first2 & cB
        insC = ((mem2_in != 1) & ~first2 & (rle >= 4) & (e_in > 0)
                & z(1) & (ac1_in == 0) & room)
        ins1 = (insB | insC) & act
        ins2 = ins2 & act
        ins = ins1 | ins2

        e_ins = e_in + ins.astype(jnp.int32)
        is254 = rle == 254
        # mem is read ONLY through mem_r == 2 (i.e. mem_in == 1), so its
        # count saturates behaviorally at 2 — clip it there.  Exact for
        # the sequential scan, and it breaks the all-run-chunk carry
        # chains in the chunked fixpoint (an unclipped mem_in + len
        # out-carry depends on the in-carry forever; min(.,2) makes any
        # >= 2-run chunk's mem out-carry in-carry-independent).
        mem_new = jnp.minimum(
            jnp.where(is254, 0, jnp.where(ins1, 1, mem_r)), 2)
        mem2_new = jnp.where(mem2_in == 1, 0, mem2_in)
        ac1_new = is254.astype(jnp.int32)
        ro_new = jnp.where(is254, e_ins, run_over)
        win_shift = jnp.where(ins, (win_in << 1) | 1, win_in)
        win_new = (win_shift << jnp.minimum(rle, 5)) & 31

        carry_new = (
            ins_cnt + ins.astype(jnp.int32),
            jnp.where(act, mem_new, mem_c),
            jnp.where(act, mem2_new, mem2_c),
            jnp.where(act, ac1_new, ac1_c),
            jnp.where(act, ro_new, run_over),
            jnp.where(act, win_new, win_c),
        )
        return carry_new, (ins, ins1, ins2, e_in)

    return step


@functools.partial(jax.jit, static_argnames=("p1", "r_max"))
def _y_automaton_runs(syms, vals, rles, sel1, sel2, p1: int, r_max: int):
    (xs, (is_run, base_e, runs_before, wv1, wv2, whas2)
     ) = _runs_xs(syms, vals, rles, p1, r_max)

    zi = jnp.int32(0)
    carry0 = (zi, zi, zi, zi, jnp.int32(-257), zi)
    # unroll=2 everywhere: the runs-only scan is already 2-3x shorter,
    # and larger unrolls blow up the XLA compile of the big (2^17-step)
    # programs
    _, (ins_seq, ev1, ev2, pos_r) = jax.lax.scan(
        _runs_step(p1), carry0, xs, unroll=2)
    return _runs_emit(ins_seq, ev1, ev2, pos_r,
                      (is_run, base_e, runs_before, wv1, wv2, whas2),
                      sel1, sel2, p1, r_max)


def _runs_emit(ins_seq, ev1, ev2, pos_r, lits, sel1, sel2, p1: int,
               r_max: int):
    """Shared emission: literal scatter from the static advance prefix
    plus carried insert counts, and the select-rank insert values."""
    is_run, base_e, runs_before, wv1, wv2, whas2 = lits
    ins_excl = jnp.concatenate(
        [jnp.zeros(1, jnp.int32),
         jnp.cumsum(ins_seq.astype(jnp.int32))])
    e_sym = base_e + ins_excl[jnp.minimum(runs_before, r_max)]
    lit = (~is_run) & (e_sym < p1 - 1)
    big = p1 + 512
    out = jnp.zeros(p1 + 512, jnp.int16)
    # distinct OOB sentinels -> unique_indices (see _runs_emit_batch)
    seqS = big + jnp.arange(e_sym.shape[0], dtype=jnp.int32)
    out = out.at[jnp.where(lit, e_sym, seqS)].set(
        wv1.astype(jnp.int16), mode="drop", unique_indices=True)
    out = out.at[jnp.where(lit & (whas2 == 1), e_sym + 4, seqS)].set(
        wv2.astype(jnp.int16), mode="drop", unique_indices=True)

    # inserted values from the select bitstream ranks
    r1 = jnp.cumsum(ev1.astype(jnp.int32)) - 1
    r2 = jnp.cumsum(ev2.astype(jnp.int32)) - 1
    sv1 = jnp.where(sel1[jnp.minimum(jnp.maximum(r1, 0),
                                     sel1.shape[0] - 1)] == 0, 11, -11)
    sv2 = jnp.where(sel2[jnp.minimum(jnp.maximum(r2, 0),
                                     sel2.shape[0] - 1)] == 0, -11, 11)
    iv = jnp.where(ev2, sv2, sv1)
    seqR = big + jnp.arange(pos_r.shape[0], dtype=jnp.int32)
    out = out.at[jnp.where(ins_seq, pos_r, seqR)].set(
        iv.astype(jnp.int16), mode="drop", unique_indices=True)
    return out[:p1]


@functools.partial(jax.jit, static_argnames=("p1", "r_max", "k_chunks"))
def _y_automaton_runs_chunked(syms, vals, rles, sel1, sel2, p1: int,
                              r_max: int, k_chunks: int = 64):
    """The runs-only automaton with its serial core cut by k_chunks:
    the r_max runs split into K chunks scanned IN PARALLEL (the scan
    carries become (K,)-vectors), and a fixpoint while_loop relays each
    chunk's out-carry into the next chunk's in-carry until nothing
    changes.

    Exactness: chunk 0's in-carry is pinned to the true initial state,
    so by induction any fixpoint of the relay equals the sequential
    solution.  The relay is the round-5 shape (see _runs_fixpoint):
    ins_cnt crosses all chunks per sweep via a prefix sum of local
    deltas; the local state components use the one-chunk shift.  This
    is a chunked "speculative decode with resync"; the k+1 bound is
    the adversarial backstop (the caller checks the returned iteration
    count)."""
    (xs, lits) = _runs_xs(syms, vals, rles, p1, r_max)
    k = min(k_chunks, r_max)
    length = r_max // k
    # time-major per-chunk inputs: (L, K)
    xs_t = jax.tree_util.tree_map(
        lambda a: a.reshape(k, length).T, xs)

    ys, iters = _runs_fixpoint.__wrapped__(xs_t, p1, k)
    ins_seq, ev1, ev2, pos_r = (a.T.reshape(r_max) for a in ys)
    return _runs_emit(ins_seq, ev1, ev2, pos_r, lits, sel1, sel2,
                      p1, r_max), iters


@functools.partial(jax.jit, static_argnames=("p1",))
def _y_automaton_batch(syms, vals, rles, sel1, sel2, p1: int):
    """vmap of the full-scan Y automaton: the scan carries become
    (B,)-wide lane vectors, so the per-step scan overhead amortizes
    across the batch."""
    return jax.vmap(
        lambda s, v, r, a, b: _y_automaton.__wrapped__(s, v, r, a, b, p1)
    )(syms, vals, rles, sel1, sel2)


@functools.partial(jax.jit, static_argnames=("p1", "r_max"))
def _y_automaton_runs_batch(syms, vals, rles, sel1, sel2, p1: int,
                            r_max: int):
    """vmap of the runs-only automaton — the throughput path: lane
    amortization times the 2-3x shorter serial core."""
    return jax.vmap(
        lambda s, v, r, a, b: _y_automaton_runs.__wrapped__(
            s, v, r, a, b, p1, r_max)
    )(syms, vals, rles, sel1, sel2)


@jax.jit
def _runs_xs_words(syms, vals, rles):
    """Per-symbol static tables + prefixes.  ONE gather total on the
    (B, s_len) hot shape: the 17-bit word-field LUT
    is folded into the per-book entry table on the tiny (B, nv) shape —
    P = fields17 << 10 | rle9 << 1 | is_run — so the per-symbol
    resolution is a single packed gather plus elementwise unpacking.
    rle <= 255 is a
    validated stream invariant (_check_book)."""
    b, s_len = syms.shape
    nv = vals.shape[1]
    pk_t = jnp.asarray(_y_word_tables_packed())
    P = ((pk_t[jnp.clip(vals, 0, 255)] << 10)
         | (jnp.clip(rles, 0, 511) << 1)
         | (vals == 0x80).astype(jnp.int32))

    rowV = (jnp.arange(b, dtype=jnp.int32) * nv)[:, None]
    sym_c = jnp.minimum(syms, nv - 1)
    pe = P.reshape(-1)[(sym_c + rowV).reshape(-1)].reshape(b, s_len)
    is_run = (pe & 1) == 1
    rle_x = (pe >> 1) & 511
    wv1, wv2, whas2, wadv, wmem2 = _unpack_word_fields(pe >> 10)

    adv_static = jnp.where(is_run, rle_x, wadv)
    base_e = jnp.cumsum(adv_static, axis=1) - adv_static
    runs_before = jnp.cumsum(is_run.astype(jnp.int32), axis=1) \
        - is_run.astype(jnp.int32)
    return (rle_x, is_run, wv1, wv2, whas2, wadv, wmem2,
            base_e, runs_before)


@jax.jit
def _runs_seg_scan(is_run, wadv):
    """Segmented associative scan of the literal window monoid, packed
    into ONE int32 lane (m bits 0-4, c bits 5-7, r bit 8) — the
    3-tuple form moved 3x the memory through every scan level (the
    clipped c never exceeds 5, so 3 bits hold it)."""
    lit_mask = jnp.where(wadv == 5, 17, 1)
    lit_cnt = jnp.where(wadv == 5, 5, 1)
    p0 = jnp.where(is_run, jnp.int32(1 << 8),
                   lit_mask | (lit_cnt << 5)).astype(jnp.int32)

    def comb(a, bb):
        am = a & 31
        ac = (a >> 5) & 7
        bm = bb & 31
        bc = (bb >> 5) & 7
        keep = (bb >> 8) == 1
        m = jnp.where(keep, bm, (bm | (am << bc)) & 31)
        c = jnp.where(keep, bc, jnp.minimum(ac + bc, 5))
        r = jnp.maximum(a >> 8, bb >> 8)
        return m | (c << 5) | (r << 8)

    pk = jax.lax.associative_scan(comb, p0, axis=1)
    return pk & 31, (pk >> 5) & 7


@functools.partial(jax.jit, static_argnames=("p1", "r_max", "k"))
def _runs_extract(rle_x, is_run, wmem2, base_e, runs_before,
                  seg_mask_all, seg_cnt_all, p1: int, r_max: int,
                  k: int):
    """Per-run input tuples via rank scatter + flat 1-D gathers.  The
    six per-run gathers collapse to three (base_e@ri plus one packed
    word per index set): rle 8b | is_run bit 8 | mem2 bit 9 |
    seg_mask 10..14 | seg_cnt 15..17."""
    b, s_len = rle_x.shape
    rowR = (jnp.arange(b, dtype=jnp.int32) * (r_max + 1))[:, None]
    sidx = jnp.broadcast_to(
        jnp.arange(s_len, dtype=jnp.int32)[None, :], (b, s_len))
    # distinct OOB sentinels -> unique_indices (see _runs_emit_batch)
    seqS = jnp.arange(b * s_len, dtype=jnp.int32).reshape(b, s_len)
    tgt = jnp.where(is_run & (runs_before < r_max),
                    runs_before + rowR, b * (r_max + 1) + seqS)
    run_idx = jnp.full(b * (r_max + 1), s_len, jnp.int32)
    run_idx = run_idx.at[tgt.reshape(-1)].set(
        sidx.reshape(-1), mode="drop", unique_indices=True)
    run_idx = run_idx.reshape(b, r_max + 1)[:, :r_max]

    vld = run_idx < s_len
    ri = jnp.minimum(run_idx, s_len - 1)
    rowS = (jnp.arange(b, dtype=jnp.int32) * s_len)[:, None]

    def gr(a, idx):
        return a.reshape(-1)[(idx + rowS).reshape(-1)].reshape(b, r_max)

    packed = (rle_x | (is_run.astype(jnp.int32) << 8) | (wmem2 << 9)
              | (seg_mask_all << 10)
              | (jnp.minimum(seg_cnt_all, 5) << 15))
    pk_ri = gr(packed, ri)
    prev = jnp.maximum(ri - 1, 0)
    pk_prev = gr(packed, prev)

    rle_r = jnp.where(vld, pk_ri & 0xFF, 0)
    e_base_r = jnp.where(vld, gr(base_e, ri), jnp.int32(p1 + (1 << 20)))
    has_prev = (run_idx > 0) & vld
    segm = jnp.where(has_prev, (pk_prev >> 10) & 31, 0)
    segc = jnp.where(has_prev, (pk_prev >> 15) & 7, 0)
    prev_is_run = ((pk_prev >> 8) & 1) == 1
    prev_run = has_prev & prev_is_run
    prev_lit_mem2 = jnp.where(has_prev & ~prev_is_run,
                              (pk_prev >> 9) & 1, 0)

    xs = (rle_r, e_base_r, segm, segc, prev_run, prev_lit_mem2, vld)
    length = r_max // k
    return jax.tree_util.tree_map(
        lambda a: a.reshape(b * k, length).T, xs), run_idx


def _runs_xs_batch(syms, vals, rles, p1: int, r_max: int, k: int):
    """Batched _runs_xs: flat 1-D gathers, rank scatter instead of the
    per-row nonzero, and THREE separate jits: as one program (a vmap
    of _runs_xs, or the flat version) the whole-program fusion pass
    made an XLA backend's compile blow up at B=32, while each phase
    alone compiles in seconds."""
    (rle_x, is_run, wv1, wv2, whas2, wadv, wmem2,
     base_e, runs_before) = _runs_xs_words(syms, vals, rles)
    seg_mask_all, seg_cnt_all = _runs_seg_scan(is_run, wadv)
    xs_t, run_idx = _runs_extract(
        rle_x, is_run, wmem2, base_e, runs_before,
        seg_mask_all, seg_cnt_all, p1, r_max, k)
    lits = (is_run, base_e, runs_before, wv1, wv2, whas2, run_idx)
    return xs_t, lits


@functools.partial(jax.jit, static_argnames=("p1", "k"))
def _runs_fixpoint(xs_t, p1: int, k: int):
    """Chunk-relay fixpoint over (B*K,) lane carries.

    Relay shape (the round-5 rebuild): ``ins_cnt`` is a GLOBAL
    cumulative count, so the plain one-chunk shift relay propagates it
    one chunk per sweep and the loop always ran K sweeps (measured:
    sweeps == K for every K on dense q20 streams).  Instead, ins_cnt is
    relayed as a per-stream exclusive prefix sum of each chunk's LOCAL
    insert delta — the additive part crosses all K chunks in one sweep
    — while the genuinely local state (mem/mem2/ac1/win/run_over) keeps
    the shift relay (it heals at literal-preceded runs / rle>=5 runs /
    254-runs within a chunk).  The fixpoint-correctness induction is
    unchanged: chunk 0 is pinned to the true initial state, and at any
    fixpoint the telescoped prefix equals the exact local insert counts,
    so by induction over chunks every carry is the sequential one.
    Sweeps drop from K to the decision-dependency depth (3-5 measured).

    Returns (ys, iters): callers must check ``iters <= k`` — the k+1
    bound exits an adversarial non-converged loop, and the caller falls
    back to the sequential runs automaton (advisor r3 finding)."""
    n = xs_t[0].shape[1]
    length = xs_t[0].shape[0]
    b = n // k
    zi = jnp.zeros((n,), jnp.int32)
    init0 = (zi, zi, zi, zi, jnp.full((n,), -257, jnp.int32), zi)
    step = _runs_step(p1)
    first = (jnp.arange(n, dtype=jnp.int32) % k) == 0
    # chunks with no possibly-active step (r_max padding and the
    # past-the-plane tail) are identity transitions: left on the shift
    # relay they drag the last real carry through the suffix one chunk
    # per sweep (measured: sweeps == K).  e_in is monotone within a
    # stream, so such chunks form a suffix whose carries feed no live
    # step — pin them to the init constants and they drop out of both
    # the relay and the convergence test.
    live = jnp.any(xs_t[1] < p1 - 1, axis=0)
    pin = first | ~live
    # run_over floor (the second chain breaker): run_over is read only
    # through room = e_in + rle - 257 >= run_over, with rle >= 1 and
    # e_in >= e_base >= this chunk's first-step e_base — so any
    # run_over <= e_base_start - 256 behaves identically (room true at
    # every step).  Clipping the relayed value up to that floor turns a
    # stale far-behind run_over into a static value, so chunks with no
    # 254-run stop chaining it one chunk per sweep.  (The init -257
    # vs a -256 floor at chunk 0: room differs only in e_in + rle == 0,
    # impossible with rle >= 1, e_in >= 0.)
    ro_floor = xs_t[1][0, :] - 256

    def relay(in_c, out_c):
        def sh(a, v0):
            prev = jnp.concatenate([jnp.full((1,), v0, a.dtype), a[:-1]])
            return jnp.where(pin, jnp.asarray(v0, a.dtype), prev)
        delta = (out_c[0] - in_c[0]).reshape(b, k)
        pref = (jnp.cumsum(delta, axis=1) - delta).reshape(n)
        return (jnp.where(pin, 0, pref), sh(out_c[1], 0), sh(out_c[2], 0),
                sh(out_c[3], 0),
                jnp.maximum(sh(out_c[4], -257), ro_floor),
                sh(out_c[5], 0))

    ys0 = (jnp.zeros((length, n), bool), jnp.zeros((length, n), bool),
           jnp.zeros((length, n), bool), jnp.zeros((length, n), jnp.int32))

    def cond(state):
        it, in_c, _, changed = state
        return changed & (it < k + 1)

    def body(state):
        it, in_c, _, _ = state
        out_c, ys = jax.lax.scan(step, in_c, xs_t, unroll=2)
        new_in = relay(in_c, out_c)
        changed = jnp.any(jnp.stack(
            [jnp.any(a != bb) for a, bb in zip(new_in, in_c)]))
        return it + 1, new_in, ys, changed

    it, _, ys, _ = jax.lax.while_loop(
        cond, body, (jnp.int32(0), init0, ys0, jnp.bool_(True)))
    return ys, it


@functools.partial(jax.jit, static_argnames=("p1", "r_max"))
def _runs_emit_batch(ys, lits, sel1, sel2, p1: int, r_max: int):
    """Batched _runs_emit: scatters flattened to 1-D over a row-offset
    index space with per-element OOB sentinels + unique_indices (the
    parallel scatter lowering), gathers as row-local take_along_axis
    (the flat 1-D form was miscompiled by an XLA backend in this
    program — see the inline comments)."""
    b = sel1.shape[0]
    ins_seq, ev1, ev2, pos_r = (a.T.reshape(b, r_max) for a in ys)
    is_run, base_e, runs_before, wv1, wv2, whas2, run_idx = lits
    s_len = base_e.shape[1]

    del run_idx  # available for scatter-based variants; measured slower
    ins_excl = jnp.concatenate(
        [jnp.zeros((b, 1), jnp.int32),
         jnp.cumsum(ins_seq.astype(jnp.int32), axis=1)], axis=1)
    # row-local take_along_axis, NOT a flat row-offset gather: in this
    # fused emit program an XLA backend's flat 1-D gather lowering
    # returned WRONG values for batch rows >= 1 (identical input rows
    # decoded differently; reproduced deterministically, standalone-jit
    # correct, sorted-hint variant equally wrong).
    # take_along_axis keeps the gather batch-dimensional and is
    # bit-exact across trials; CPU agrees with both formulations.
    # (A run_idx rank-scatter + cumsum variant measured 87 vs 72
    # ms/batch for this take_along form — gathers over the small
    # (B, r_max+1) table batch efficiently.)
    e_sym = base_e + jnp.take_along_axis(
        ins_excl, jnp.minimum(runs_before, r_max), axis=1)

    stride = p1 + 512
    total = b * stride
    rowO = (jnp.arange(b, dtype=jnp.int32) * stride)[:, None]
    lit = (~is_run) & (e_sym < p1 - 1)
    # ONE fused scatter (round 5; was three).  Literal values pack as
    # lo16 = wv1, hi16 = wv2 when the word double-emits at e+4 — since
    # unique_indices guarantees nothing else writes e+4, the second
    # emission becomes a post-scatter shift-by-4 of the hi halves added
    # onto the lo plane (a vector roll instead of 8M more scatter
    # updates).  The select-insert updates ride the same scatter call
    # with their own index block.
    # per-element OOB sentinels keep every index distinct, so the
    # scatter can promise unique_indices=True — without it XLA may
    # serialize each 8M-update scatter
    seqS = jnp.arange(b * s_len, dtype=jnp.int32).reshape(b, s_len)
    idx1 = jnp.where(lit, e_sym + rowO, total + seqS).reshape(-1)
    val1 = ((wv1 & 0xFFFF)
            | jnp.where(whas2 == 1, wv2 << 16, 0)).reshape(-1)

    # inserted values from the per-stream select bitstream ranks
    sl = sel1.shape[1]
    r1 = jnp.cumsum(ev1.astype(jnp.int32), axis=1) - 1
    r2 = jnp.cumsum(ev2.astype(jnp.int32), axis=1) - 1
    # take_along_axis for the same reason as e_sym above
    b1 = jnp.take_along_axis(sel1, jnp.clip(r1, 0, sl - 1), axis=1)
    b2 = jnp.take_along_axis(sel2, jnp.clip(r2, 0, sel2.shape[1] - 1),
                             axis=1)
    sv1 = jnp.where(b1 == 0, 11, -11)
    sv2 = jnp.where(b2 == 0, -11, 11)
    iv = jnp.where(ev2, sv2, sv1)
    seqR = jnp.arange(b * r_max, dtype=jnp.int32).reshape(b, r_max)
    idx3 = jnp.where(ins_seq, pos_r + rowO, total + seqR).reshape(-1)
    val3 = iv.astype(jnp.int32) & 0xFFFF

    out32 = jnp.zeros(total, jnp.int32)
    out32 = out32.at[jnp.concatenate([idx1, idx3.reshape(-1)])].set(
        jnp.concatenate([val1, val3.reshape(-1)]),
        mode="drop", unique_indices=True)
    lo = (out32 & 0xFFFF).astype(jnp.int16)
    hi = (out32 >> 16).astype(jnp.int16)
    out = lo + jnp.concatenate([jnp.zeros(4, jnp.int16), hi[:-4]])
    return out.reshape(b, stride)[:, :p1]


def _y_automaton_runs_chunked_batch(syms, vals, rles, sel1, sel2,
                                    p1: int, r_max: int,
                                    k_chunks: int = 64):
    """Batched chunked-fixpoint runs automaton with the batch FOLDED
    INTO the chunk-lane axis: one flat while_loop over (B*K,) carries,
    with the carry relay masked at stream boundaries so chunk 0 of
    every stream takes the true initial state.

    Three separate jits (xs-prep / fixpoint / emit) on purpose: fused
    into one program, an XLA backend's compile did not finish at B=32
    (with or without vmap around the while_loop) while each phase alone
    compiles in seconds.  The handoffs are device-resident; the extra
    traffic is ~100 MB/batch.

    If the relay hits its k+1 iteration bound without converging (an
    adversarial stream shaped to defeat the prefix relay — never seen
    on real or fuzzed streams), the results are untrusted and the batch
    falls back to the exact sequential runs automaton."""
    k = min(k_chunks, r_max)
    xs_t, lits = _runs_xs_batch(syms, vals, rles, p1, r_max, k)
    ys, iters = _runs_fixpoint(xs_t, p1, k)
    if int(iters) > k:  # one scalar sync; bound only ever hit adversarially
        return _y_automaton_runs_batch(syms, vals, rles, sel1, sel2,
                                       p1, r_max)
    return _runs_emit_batch(ys, lits, sel1, sel2, p1, r_max)


def _chain_batch_words(streams: list):
    """The batch's Y code words padded to a common bucket, bit counts,
    and the per-stream zone mode (a traced vector)."""
    nw = 1 << max(7, int(max(s.packet1.size for s in streams)
                         ).bit_length())
    wordsB = np.zeros((len(streams), nw), np.uint32)
    for i, s in enumerate(streams):
        wordsB[i, :s.packet1.size] = s.packet1
    nbits = np.asarray([s.packet1.size * 32 for s in streams], np.int32)
    zone = np.asarray([1 if s.res_high < 4 else 0 for s in streams],
                      np.int32)
    return jnp.asarray(wordsB), jnp.asarray(nbits), jnp.asarray(zone)


def _chain_batch_scan(streams: list, s_max: int):
    """One chain-extraction launch for the whole batch
    (see _chain_dispatch for the form)."""
    return _chain_dispatch(*_chain_batch_words(streams), s_max)


def decode_y_device_batch(streams: list, p1: int = 4 * T.IM_SIZE,
                          use_runs: bool = False,
                          automaton: str | None = None,
                          k_chunks: int = 64) -> list[np.ndarray]:
    """Batched device decode of Y symbol planes for parsed NHWStreams
    (same results as entropy.decode_y per stream).  Chain extraction is
    ONE gather-free launch for the whole batch (entropy_chain_scan);
    books/selects are padded to common buckets.

    ``automaton``: "chunked" (default — the K-parallel fixpoint runs
    automaton), "runs", or "full"; ``use_runs`` kept for back-compat
    (True == "runs").

    Worst-case bound of the default: the chunked fixpoint converges in
    at most ``k_chunks + 1`` sweeps (chunk 0 is pinned after sweep 1,
    chunk i after sweep i+1), so an adversarial stream whose carry
    influence is never local costs up to ~(k+1)x the runs automaton's
    single sweep.  Real streams settle in 2-3 sweeps (the select/run
    state re-synchronises within a chunk); use ``automaton="runs"`` for
    a latency-deterministic single sweep."""
    if automaton is None:
        automaton = "runs" if use_runs else "chunked"

    symB, vB, rB, s1B, s2B, r_max = _y_batch_inputs(streams, p1)
    if automaton == "chunked":
        out = _y_automaton_runs_chunked_batch(symB, vB, rB, s1B, s2B,
                                              p1, r_max, k_chunks)
    elif automaton == "runs":
        out = _y_automaton_runs_batch(symB, vB, rB, s1B, s2B, p1, r_max)
    else:
        out = _y_automaton_batch(symB, vB, rB, s1B, s2B, p1)
    res = np.asarray(out)
    return [res[i] for i in range(len(streams))]


def _y_batch_inputs(streams: list, p1: int):
    """The batched Y automata's inputs: chain-extracted symbols trimmed
    to a shape bucket, books and select bits padded to common buckets,
    and the run-count bucket r_max."""
    from nhwcodec_tpu.ops import entropy

    all_nbits = [s.packet1.size * 32 for s in streams]
    s_max = min(p1, max(64, max(all_nbits) // 2 + 2))
    s_max = 1 << (s_max - 1).bit_length()

    symB_full, countB = _chain_batch_scan(streams, s_max)

    def pad_rows(rows, fill=0):
        n = 1 << max(6, (max(len(r) for r in rows) - 1).bit_length())
        out = np.full((len(rows), n), fill, np.int32)
        for i, r in enumerate(rows):
            out[i, :len(r)] = r
        return jnp.asarray(out)

    books = [entropy.build_y_book(s.tree1) for s in streams]
    for bk in books:
        _check_book(bk[0], bk[1], "Y")
    sels1 = [np.unpackbits(np.ascontiguousarray(s.select_word1, np.uint8))
             for s in streams]
    sels2 = [np.unpackbits(np.ascontiguousarray(s.select_word2, np.uint8))
             for s in streams]
    vB = pad_rows([b[0] for b in books])
    rB = pad_rows([b[1] for b in books])
    # one launch for every stream's run count (not 2 per stream)
    runsB = _run_count_batch(symB_full, vB, countB)
    cr = np.asarray(jnp.stack([countB, runsB]))
    counts, runs = cr[0], cr[1]
    # quarter-octave shape buckets (<=25% padding vs pow2's 2x; at most
    # 4 compiled shape classes per octave)
    s_trim = min(_bucket(int(counts.max()) + 1), s_max)
    r_max = _bucket(int(max(runs.max(), 1)))

    return (symB_full[:, :s_trim], vB, rB, pad_rows(sels1),
            pad_rows(sels2), r_max)


def decode_uv_device(packet2: np.ndarray, tree2: np.ndarray,
                     tree_end: int, p1: int = 2 * T.IM_SIZE - 1
                     ) -> np.ndarray:
    """Device decode of the UV symbol plane; bit-exact vs
    entropy.decode_uv.  Fully parallel (no scan)."""
    from nhwcodec_tpu.ops import entropy

    vals, rles = entropy.build_uv_book(tree2, tree_end)
    _check_book(vals, rles, "UV")
    vd, rd = _book_device(vals, rles)
    words, nbits = _words_device(packet2)
    s_max = min(p1 + 1, max(64, nbits // 2 + 2))
    s_max = 1 << (s_max - 1).bit_length()
    syms, _ = _chain_dispatch(
        words[None], jnp.asarray([nbits], jnp.int32),
        jnp.zeros(1, jnp.int32), s_max)
    return np.asarray(_uv_scatter(syms[0], vd, rd, p1))


@functools.partial(jax.jit, static_argnames=("p1",))
def _uv_scatter_batch(syms, vals, rles, p1: int):
    """Batched _uv_scatter: per-row book resolution via take_along_axis
    (an XLA backend miscompiled the flat row-offset gather form in
    fused programs — see _runs_emit_batch) and one unique-index
    scatter."""
    b, s_len = syms.shape
    nv = vals.shape[1]
    val_t = jnp.asarray(_uv_word_table())
    sym_c = jnp.clip(syms, 0, nv - 1)
    vr = jnp.take_along_axis(vals | (rles << 10), sym_c, axis=1)
    word = vr & 1023
    rle = vr >> 10
    is_run = word == 0x80
    adv = jnp.where(is_run, rle, 1)
    e_start = jnp.concatenate(
        [jnp.zeros((b, 1), jnp.int32),
         jnp.cumsum(adv, axis=1)[:, :-1]], axis=1)
    live = (e_start < p1 - 1) & (~is_run)
    stride = p1 + 512
    total = b * stride
    rowO = (jnp.arange(b, dtype=jnp.int32) * stride)[:, None]
    seqS = jnp.arange(b * s_len, dtype=jnp.int32).reshape(b, s_len)
    idx = jnp.where(live, e_start + rowO, total + seqS).reshape(-1)
    vv = val_t[word.reshape(-1)].astype(jnp.int16)
    out = jnp.zeros(total, jnp.int16)
    out = out.at[idx].set(vv, mode="drop", unique_indices=True)
    return out.reshape(b, stride)[:, : 2 * T.IM_SIZE]


def decode_uv_device_batch(streams: list,
                           p1: int = 2 * T.IM_SIZE - 1
                           ) -> list[np.ndarray]:
    """Batched UV symbol-plane decode for parsed NHWStreams — one chain
    launch + one scatter launch for the whole batch; bit-exact vs
    entropy.decode_uv per stream."""
    from nhwcodec_tpu.ops import entropy

    nw = 1 << max(7, int(max(s.packet2.size for s in streams)
                         ).bit_length())
    wordsB = np.zeros((len(streams), nw), np.uint32)
    for i, s in enumerate(streams):
        wordsB[i, :s.packet2.size] = s.packet2
    nbits = np.asarray([s.packet2.size * 32 for s in streams], np.int32)
    s_max = min(p1 + 1, max(64, int(nbits.max()) // 2 + 2))
    s_max = 1 << (s_max - 1).bit_length()
    syms, _ = _chain_dispatch(jnp.asarray(wordsB), jnp.asarray(nbits),
                              jnp.zeros(len(streams), jnp.int32), s_max)

    def pad_rows(rows, fill=0):
        n = 1 << max(6, (max(len(r) for r in rows) - 1).bit_length())
        out = np.full((len(rows), n), fill, np.int32)
        for i, r in enumerate(rows):
            out[i, :len(r)] = r
        return jnp.asarray(out)

    books = [entropy.build_uv_book(s.tree2, s.tree_end) for s in streams]
    for bk in books:
        _check_book(bk[0], bk[1], "UV")
    vB = pad_rows([bk[0] for bk in books])
    rB = pad_rows([bk[1] for bk in books])
    res = np.asarray(_uv_scatter_batch(syms, vB, rB, p1))
    return [res[i] for i in range(len(streams))]
