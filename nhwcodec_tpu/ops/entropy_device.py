"""Device-side entropy-coding building blocks (JAX/XLA).

The reference's bit-serial Huffman packer
(encoder/compress_pixel.c:280-361) advances one symbol at a time; on a
device the same packing is a *parallel prefix* computation (SURVEY.md
section 5, long-context row): a cumulative sum over code lengths yields every
symbol's start bit, and each code then scatters into at most two 32-bit
words.  Bit contributions never overlap, so the scatter-OR is a
scatter-add — one fused XLA program for the whole stream.

The token stream itself (symbol indices after run-length segmentation)
comes from the host tokenizer; this module turns tokens into packed
words at device speed and is the building block for the batched device
entropy stage.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from nhwcodec_tpu import tables as T


def pack_bits_device(codes: jnp.ndarray, lens: jnp.ndarray,
                     n_words: int) -> jnp.ndarray:
    """Pack (code, nbits) pairs MSB-first into 32-bit words.

    codes: (..., S) uint32 right-aligned code values; lens: (..., S) int32
    bit counts (0 allowed: emits nothing).  Returns (..., n_words) uint32.
    Matches the reference packer's layout exactly
    (encoder/compress_pixel.c:345-355).
    """
    codes = jnp.asarray(codes, jnp.uint32)
    lens = jnp.asarray(lens, jnp.int32)
    ends = jnp.cumsum(lens, axis=-1)
    starts = ends - lens

    word_idx = starts >> 5
    shift = starts & 31
    # each code lands in a 64-bit window [word_idx, word_idx+1]; formulated
    # in 32-bit ops (uint64 is unavailable without jax_enable_x64)
    over = shift + lens - 32          # bits spilling into the second word
    hi = jnp.where(over > 0,
                   codes >> jnp.clip(over, 0, 31).astype(jnp.uint32),
                   codes << jnp.clip(-over, 0, 31).astype(jnp.uint32))
    lo = jnp.where(over > 0,
                   codes << jnp.clip(32 - over, 0, 31).astype(jnp.uint32),
                   jnp.uint32(0))

    out = jnp.zeros(codes.shape[:-1] + (n_words + 1,), jnp.uint32)
    mask = lens > 0
    out = out.at[..., word_idx].add(jnp.where(mask, hi, 0))
    out = out.at[..., word_idx + 1].add(jnp.where(mask, lo, 0))
    return out[..., :n_words]


pack_bits_device_jit = jax.jit(pack_bits_device, static_argnames=("n_words",))


@jax.jit
def _tokens_to_codes_zone(pos):
    """Zone-coded stream (encoder/compress_pixel.c:329-341): positions
    110..173 take the 15-bit zone escape, >=174 shift down 64."""
    zone_tok = (pos >= 110) & (pos < 174)
    plain = jnp.where(zone_tok, 0, jnp.where(pos >= 174, pos - 64, pos))
    codes = jnp.where(zone_tok,
                      (1 << 6) | jnp.maximum(pos - 110, 0),
                      jnp.asarray(T.HUFFMAN_CODES, jnp.uint32)[plain])
    lens = jnp.where(zone_tok, 15,
                     jnp.asarray(T.HUFFMAN_LENS, jnp.int32)[plain])
    return codes.astype(jnp.uint32), lens


@jax.jit
def _tokens_to_codes_plain(pos):
    codes = jnp.asarray(T.HUFFMAN_CODES, jnp.uint32)[pos]
    lens = jnp.asarray(T.HUFFMAN_LENS, jnp.int32)[pos]
    return codes, lens


# the native emitter reads a 354-entry code table (codebooks can exceed
# the 290 static codes when the zone shift is off); mirror its
# zero-padded tail so device and host resolve identical bits
_CODES354 = np.zeros(354, np.uint32)
_CODES354[:290] = T.HUFFMAN_CODES
_LENS354 = np.zeros(354, np.int32)
_LENS354[:290] = T.HUFFMAN_LENS


@jax.jit
def _pack_rows(pos, zone, valid):
    """(R, S) token positions -> (R, n_words) packed words + (R,) bit
    counts, one program for the whole batch.

    Each row is an independent (image, stream-part) pack of the
    reference layout (encoder/compress_pixel.c:280-361): per-token
    code/length lookup (15-bit zone escape for positions 110..173 when
    the row's zone flag is set), prefix-sum of lengths for start bits,
    and a scatter-add into 32-bit words.  The scatter stays 1-D (rows
    flattened into one index space)."""
    n_words = _pack_rows_n_words(pos.shape[1])
    codes_t = jnp.asarray(_CODES354, jnp.uint32)
    lens_t = jnp.asarray(_LENS354, jnp.int32)

    zone_tok = zone[:, None] & (pos >= 110) & (pos < 174)
    plain = jnp.where(zone_tok, 0,
                      jnp.where(zone[:, None] & (pos >= 174), pos - 64, pos))
    codes = jnp.where(zone_tok, (pos - 110 + 64).astype(jnp.uint32),
                      codes_t[plain])
    lens = jnp.where(zone_tok, 15, lens_t[plain])
    lens = jnp.where(valid, lens, 0)

    ends = jnp.cumsum(lens, axis=-1)
    starts = ends - lens
    word_idx = jnp.minimum(starts >> 5, n_words - 1)  # overflow rows stay
    shift = starts & 31                               # inside their slot
    over = shift + lens - 32
    hi = jnp.where(over > 0,
                   codes >> jnp.clip(over, 0, 31).astype(jnp.uint32),
                   codes << jnp.clip(-over, 0, 31).astype(jnp.uint32))
    lo = jnp.where(over > 0,
                   codes << jnp.clip(32 - over, 0, 31).astype(jnp.uint32),
                   jnp.uint32(0))

    r, w = pos.shape[0], n_words + 1
    flat = (jnp.arange(r, dtype=jnp.int32)[:, None] * w + word_idx).reshape(-1)
    mask = (lens > 0).astype(jnp.uint32)
    out = jnp.zeros((r * w,), jnp.uint32)
    out = out.at[flat].add((hi * mask).reshape(-1))
    out = out.at[flat + 1].add((lo * mask).reshape(-1))
    return out.reshape(r, w)[:, :n_words], ends[:, -1]


def _pack_rows_n_words(s: int) -> int:
    """Word capacity for S-token rows: 20 bits/token worst case, capped
    at the format's 80000-word stream guard
    (encoder/compress_pixel.c:234,270-271)."""
    return min(80000, (20 * s) // 32 + 2)


def pack_token_rows(pos_rows: list[np.ndarray], zone_rows: list[bool]
                    ) -> tuple[np.ndarray, np.ndarray]:
    """Batch-pack R token rows in ONE device program.

    pos_rows: per-row int32 codebook positions (ragged); zone_rows:
    per-row zone flag.  Rows are padded to a shared power-of-two bucket
    so the program compiles once per bucket.  Returns
    (words (R, n_words) uint32, nbits (R,) int32); callers slice each
    row to ``(nbits+31)>>5`` words and must treat
    ``nbits > 32*n_words`` as stream overflow."""
    r = len(pos_rows)
    s = max(1024, max((len(p) for p in pos_rows), default=1))
    s = 1 << (s - 1).bit_length()
    rb = 1 << (max(1, r) - 1).bit_length()
    pos = np.zeros((rb, s), np.int32)
    valid = np.zeros((rb, s), bool)
    zone = np.zeros((rb,), bool)
    for k, p in enumerate(pos_rows):
        pos[k, : len(p)] = p
        valid[k, : len(p)] = True
        zone[k] = bool(zone_rows[k])
    words, nbits = _pack_rows(jnp.asarray(pos), jnp.asarray(zone),
                              jnp.asarray(valid))
    return np.asarray(words[:r]), np.asarray(nbits[:r])


def tokens_to_words(positions: np.ndarray, zone_on: bool,
                    n_words: int, valid: np.ndarray | None = None
                    ) -> tuple[np.ndarray, int]:
    """Codebook-position tokens -> (packed u32 words, total bit count)
    on device.

    positions: (S,) int32 codebook indices (post run segmentation,
    the host nhw_tokenize walk); zone_on: whether this stream part uses
    the 15-bit zone escape for positions 110..173
    (decoder/compress_pixel.c:141-187's inverse); valid: optional (S,)
    bool mask (padding tokens emit zero bits).  The per-token
    code/length lookup and the packing are one device program.
    """
    pos = jnp.asarray(positions, jnp.int32)
    if zone_on:
        codes, lens = _tokens_to_codes_zone(pos)
    else:
        codes, lens = _tokens_to_codes_plain(pos)
    if valid is not None:
        lens = jnp.where(jnp.asarray(valid, jnp.bool_), lens, 0)
    nbits = int(jnp.sum(lens))
    return np.asarray(pack_bits_device_jit(codes, lens, n_words)), nbits
