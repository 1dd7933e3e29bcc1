"""Device formulations of the encoder's post-transform raster scans.

The encode side's device scans: the E11 band cleanup ladders, the E14
quantizer, the E15 serpentine/select stream fixups and the E12
positional streams run as batched XLA programs, bit-exact vs the host C
scans (ops/quantize.py, models/encoder.py), so a full-device encode
configuration exists symmetric to decode's ``entropy_on_device``.

Design notes (each pass analyzed against the reference semantics,
encoder/nhw_encoder.c:1893-2252 / encoder/image_processing.c:185-521):

- ``snap_pass``: the raster pass's neighbour-count test |pf[nb]|+2>=8
  is STATIC — alive values (|initial| >= thr) remain |.| >= 6 under
  every modification the pass can make (snap to +-7, the >=8
  decrements, the -8 overwrites, the <-14 increments), dead in-region
  positions zero exactly when visited after their row predecessor, and
  right/below reads happen before any write can land there.  The only
  dynamic dependency is the left-neighbour fixup chain within a row, a
  Jacobi fixpoint like the requant ladder (models/device_requant.py).
- pair promotions (offset_y passes 2-3): the sequential skip_until
  consume rule over a static qualifying predicate F equals firing at
  the even offsets of each maximal F-run (greedy matching parity) —
  pure vector ops; the first pass's cross-row sentinel writes sequence
  through a 256-step lax.scan over rows.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

D = 256
N = 512
SZ = 65536


def _col_iota(xp=jnp):
    return jax.lax.broadcasted_iota(jnp.int32, (N, N), 1)


def _row_iota(xp=jnp):
    return jax.lax.broadcasted_iota(jnp.int32, (N, N), 0)


def _zpad(x, axis_pairs, fill):
    pw = [(0, 0)] * x.ndim
    for ax, pair in axis_pairs:
        pw[ax] = pair
    return jnp.pad(x, pw, constant_values=fill)


def _shift_right(x, fill=0):
    """x[..., j-1] at j (left neighbour), row-local."""
    return _zpad(x[..., :-1], [(-1, (1, 0))], fill)


def _shift_left(x, fill=0):
    return _zpad(x[..., 1:], [(-1, (0, 1))], fill)


def _shift_down(x, fill=0):
    """x[..., r-1, :] at r (upper neighbour)."""
    return _zpad(x[..., :-1, :], [(-2, (1, 0))], fill)


def _shift_up(x, fill=0):
    return _zpad(x[..., 1:, :], [(-2, (0, 1))], fill)


def _snap_decide(v, cnt, yw: int, yw2: int, second_rule: bool,
                 snap_guard6: bool):
    """The snap decision for one alive position given its current value
    v and the static neighbour count (encoder/nhw_encoder.c:1923-1960)."""
    in_band = (v > -yw) & (v < yw)
    fire1 = (jnp.abs(v) < yw2) & (cnt < 3) & in_band
    if snap_guard6:
        s1 = jnp.where(v < -6, -7, jnp.where(v > 6, 7, v))
    else:
        s1 = jnp.where(v < 0, -7, 7)
    out = jnp.where(fire1, s1, v)
    if second_rule:
        fire2 = (~fire1) & (cnt == 0) & (jnp.abs(v) < yw2)
        out = jnp.where(fire2, jnp.where(v < 0, -7, 7), out)
    return out


@functools.partial(jax.jit, static_argnames=(
    "r0", "r1", "col0", "col1", "thr", "yw", "yw2", "second_rule",
    "snap_guard6", "gc"))
def snap_pass_device(plane, r0: int, r1: int, col0: int, col1: int,
                     thr: int, yw: int, yw2: int, second_rule: bool,
                     snap_guard6: bool, gc: int):
    """One _band_snap_pass on a (B,512,512) int16 plane, bit-exact vs
    models.encoder._band_snap_pass (tests/test_device_scans.py).

    Static analysis in the module docstring; the Jacobi state is the
    post-snap e plane (pre self-overwrite — the value neighbours'
    fixups classify on)."""
    I = plane.astype(jnp.int32)
    col = _col_iota()
    row = _row_iota()
    in_reg = ((row >= r0) & (row < r1) & (col >= col0) & (col < col1))
    alive = in_reg & (jnp.abs(I) >= thr)

    # static neighbour-count: left/up read post-pass values (alive ->
    # always true; dead in-region -> zeroed false; out-of-region -> the
    # pass-input value), right/down read pass-input values
    def tr_final(nb_alive, nb_inreg, nb_I):
        return jnp.where(nb_inreg, nb_alive, jnp.abs(nb_I) >= 6)

    def tr_initial(nb_I):
        return jnp.abs(nb_I) >= 6

    cnt = (
        tr_final(_shift_right(alive), _shift_right(in_reg),
                 _shift_right(I)).astype(jnp.int32)
        + tr_initial(_shift_left(I)).astype(jnp.int32)
        + tr_final(_shift_down(alive), _shift_down(in_reg),
                   _shift_down(I)).astype(jnp.int32)
        + tr_initial(_shift_up(I)).astype(jnp.int32))

    IL = _shift_left(I)          # I[a+1]
    colm1 = col - 1              # column of the left neighbour

    def delta_in(e_left):
        """Value of a after the left neighbour's fixup phase, given the
        left's post-snap e (classes per the elif chain; the e==8 branch
        is unreachable — e>=8 & (e&7)<2 matches first)."""
        la = _shift_right(alive)
        dec = la & (e_left >= 8) & ((e_left & 7) < 2)
        negdec = la & (e_left < -7) & (((-e_left) & 7) < 2)
        v = I
        v = jnp.where(dec & (I > 7) & (I < 10000), I - 1, v)
        n_ok = negdec & (I < -14)
        inc7 = n_ok & (((-I) & 7) == 7)
        inc_lo = (n_ok & (((-I) & 7) < 2) & ~(((-I) & 7) == 7)
                  & (colm1 < gc) & (IL <= 0))
        v = jnp.where(inc7 | inc_lo, I + 1, v)
        return v

    def body(state):
        e, _ = state
        el = _shift_right(e)
        v = delta_in(el)
        e2 = jnp.where(alive,
                       _snap_decide(v, cnt, yw, yw2, second_rule,
                                    snap_guard6), e)
        return e2, jnp.any(e2 != e)

    e0 = jnp.where(alive,
                   _snap_decide(I, cnt, yw, yw2, second_rule,
                                snap_guard6), I)
    e, _ = jax.lax.while_loop(lambda s: s[1], body,
                              (e0, jnp.bool_(True)))

    # self-overwrite (the e==-7 & I[a+1]==8 branch writes its OWN slot)
    e_final = jnp.where(alive & (e == -7) & (IL == 8), -8, e)

    # the spill write one column right of the region (fixups from the
    # last region column land on col1, which is not in in_reg)
    out = jnp.where(alive, e_final, jnp.where(in_reg, 0, I))
    lastcol = alive & (col == col1 - 1)
    e_lastL = _shift_right(jnp.where(lastcol, e, 0))
    la = _shift_right(lastcol)
    dec = la & (e_lastL >= 8) & ((e_lastL & 7) < 2)
    negdec = la & (e_lastL < -7) & (((-e_lastL) & 7) < 2)
    spill = (col == col1) & (row >= r0) & (row < r1)
    v = out
    v = jnp.where(spill & dec & (I > 7) & (I < 10000), I - 1, v)
    n_ok = spill & negdec & (I < -14)
    inc7 = n_ok & (((-I) & 7) == 7)
    inc_lo = (n_ok & (((-I) & 7) < 2) & ~(((-I) & 7) == 7)
              & (colm1 < gc) & (IL <= 0))
    v = jnp.where(inc7 | inc_lo, I + 1, v)
    return v.astype(jnp.int16)


# ---------------------------------------------------------------------------
# E14: the scalar quantizer (ops/quantize.offset_y / offset_uv)


def _sentinel_code(a):
    """The >10000 sentinel -> code-byte map of offset_y pass 4."""
    return jnp.where(
        a == 10100, 128, jnp.where(
            a == 12700, 127, jnp.where(
                a == 12900, 129, jnp.where(
                    a == 10204, 125, jnp.where(
                        a == 10300, 126, jnp.where(
                            a == 12100, 121, jnp.where(
                                a == 12200, 122, a)))))))


def _escape_code(a, xp=jnp):
    """|a| > 127 escape words (EXTRA_WORDS1/2)."""
    from nhwcodec_tpu.ops.quantize import EXTRA_WORDS1, EXTRA_WORDS2

    e1 = jnp.asarray(EXTRA_WORDS1, jnp.int32)
    e2 = jnp.asarray(EXTRA_WORDS2, jnp.int32)
    exw_p = jnp.minimum(((a & 0xfff8) - 128) >> 3, 18)
    exw_n = jnp.minimum((((-a) & 0xfff8) - 128) >> 3, 18)
    return jnp.where(a > 127, e1[jnp.clip(exw_p, 0, 18)],
                     e2[jnp.clip(exw_n, 0, 18)])


def _flat_shift_l(x, k=1, fill=0):
    return _zpad(x[..., k:], [(-1, (0, k))], fill)


def _flat_shift_r(x, k=1, fill=0):
    return _zpad(x[..., :-k], [(-1, (k, 0))], fill)


def _offset_y_pass1(If):
    """Even-pair decrements in the bands (image_processing.c:194-237),
    a left-to-right Jacobi chain on the flat plane: a candidate's value
    may carry one decrement from its left neighbour, which flips the
    parity its own decision reads.  Conditions on I[x+-1..2] are
    initial-value-pure (no writer precedes the read)."""
    n = If.shape[-1]
    col = jax.lax.broadcasted_iota(jnp.int32, (n,), 0) & 511
    flat = jax.lax.broadcasted_iota(jnp.int32, (n,), 0)
    reg = ((flat >= 2 * SZ) | (col >= D)) & (col < 2 * D - 1)
    IL = _flat_shift_l(If)
    IL2 = _flat_shift_l(If, 2)
    IRs = _flat_shift_r(If)            # I[x-1], static-sign reads
    outer_R = (IL > 7) & ((IL & 7) == 0) & (IL > 15) \
        & (col < 2 * D - 2) & (IL2 <= 0)

    def step(dec):
        a = If - dec
        outer = reg & (a > 7) & (IL > 7) & ((a & 7) == 0) \
            & ((IL & 7) == 0)
        caseA = outer & (a > 15) & (flat > 0) & (IRs <= 0)
        caseB = outer & (a > 15) & (flat > 0) & ~(IRs <= 0) & outer_R
        caseBp = outer & ~(a > 15) & outer_R
        give = (caseB | caseBp).astype(jnp.int32)
        return _flat_shift_r(give), caseA

    dec = jnp.zeros_like(If)

    def body(state):
        d, _, _ = state
        d2, cA = step(d)
        return d2, cA, jnp.any(d2 != d)

    d0, cA0 = step(dec)
    dec, caseA, _ = jax.lax.while_loop(
        lambda s: s[2], body, (d0, cA0, jnp.bool_(True)))
    return If - dec - caseA.astype(jnp.int32)


def _run_parity_fire(F):
    """fired = F & even(offset within the maximal F-run) — the greedy
    fire-and-consume-next rule over a static predicate."""
    n = F.shape[-1]
    idx = jax.lax.broadcasted_iota(jnp.int32, F.shape, F.ndim - 1)
    # start of the current F-run: cummax of (idx where ~F else -1)+1
    brk = jnp.where(F, -1, idx)
    start = jax.lax.cummax(brk, axis=F.ndim - 1) + 1
    return F & (((idx - start) & 1) == 0)


def _offset_y_pass2(plane):
    """First pair-promotion pass (image_processing.c:241-283): rows
    0..255, cols 1..254 of the 512-wide plane; vertical fires write
    10100 into the next row, so rows sequence through a lax.scan."""
    b = plane.shape[0]
    I_rows = plane[:, :D, :D]                      # (B, 256, 256)
    band = plane[:, :D, D:]                        # untouched
    colv = jax.lax.broadcasted_iota(jnp.int32, (D,), 0)

    def row_step(pend, xs):
        I_r, I_r1 = xs                             # (B, 256) each
        v = jnp.where(pend, 10100, I_r)
        vl = _zpad(v[:, :-1], [(-1, (1, 0))], 0)   # v[j-1]
        vr = _zpad(v[:, 1:], [(-1, (0, 1))], 0)    # v[j+1]
        n1l = _zpad(I_r1[:, :-1], [(-1, (1, 0))], 0)   # I[r+1][j-1]
        ok = (colv >= 1) & (colv < D - 1)
        fp = ok & (v > 3) & (v < 8) & (vl > 3) & (vl <= 7)
        fph = fp & (vr > 3) & (vr <= 7)
        fpv = fp & ~fph & (n1l > 3) & (n1l <= 7) & (I_r1 > 3) \
            & (I_r1 <= 7)
        fn = ok & (v > -8) & (v < -3) & (vl > -8) & (vl <= -4)
        fnh = fn & (vr > -8) & (vr <= -4)
        fnv = fn & ~fnh & (n1l > -8) & (n1l <= -4) & (I_r1 > -8) \
            & (I_r1 <= -4)
        fired = _run_parity_fire(fph | fpv | fnh | fnv)
        fh = fired & (fph | fnh)
        fv = fired & (fpv | fnv)
        out = v
        out = jnp.where(fh, jnp.where(fph, 12700, 12900), out)
        out = jnp.where(fv, 10100, out)
        left_val = jnp.where(fh, 10100,
                             jnp.where(fpv, 12100, 12200))
        wl = _zpad((fh | fv)[:, 1:], [(-1, (0, 1))], False)
        lv = _zpad(left_val[:, 1:], [(-1, (0, 1))], 0)
        out = jnp.where(wl, lv, out)
        pend_next = fv | _zpad(fv[:, 1:], [(-1, (0, 1))], False)
        return pend_next, out

    xs = (jnp.swapaxes(I_rows, 0, 1),
          jnp.swapaxes(jnp.concatenate(
              [I_rows[:, 1:], plane[:, D:D + 1, :D]], axis=1), 0, 1))
    pend0 = jnp.zeros((b, D), bool)
    pend_last, outs = jax.lax.scan(row_step, pend0, xs)
    new_ll = jnp.swapaxes(outs, 0, 1)
    plane = plane.at[:, :D, :D].set(new_ll.astype(plane.dtype))
    # row 255's vertical fires write into plane row 256 (the band area)
    return plane.at[:, D, :D].set(
        jnp.where(pend_last, jnp.asarray(10100, plane.dtype),
                  plane[:, D, :D]))


def _offset_y_pass3(plane):
    """Second pair-promotion pass (10300/10204): own-writes only, so
    rows are independent — pure parity fire."""
    v = plane[:, :D, :D].astype(jnp.int32)
    vr = _zpad(v[..., 1:], [(-1, (0, 1))], 0)
    colv = jax.lax.broadcasted_iota(jnp.int32, (D, D), 1)
    ok = colv < D - 1
    inp = (v >= 5) & (v <= 7)
    inn = (v >= -7) & (v <= -5)
    fp = ok & inp & (vr >= 5) & (vr <= 7)
    fn = ok & inn & (vr >= -7) & (vr <= -5)
    fired = _run_parity_fire(fp | fn)
    out = jnp.where(fired, jnp.where(fp, 10300, 10204), v)
    return plane.at[:, :D, :D].set(out.astype(plane.dtype))


def _offset_y_pass4(If, m1: int):
    """The quantizer itself (image_processing.c:312-520), q > LOW4 (no
    duty-cycle counters).  Two phases, both initial-value-pure: the
    fixup writes (-9/-8/9 onto x+1) never themselves fire fixups, and
    their trigger values (-7/7) fire none either, so the write plane
    computes from I alone; the code map then runs per position."""
    n = If.shape[-1]
    col = jax.lax.broadcasted_iota(jnp.int32, (n,), 0) & 511
    IL = _flat_shift_l(If)
    incol = col < 2 * D - 1

    # fixup writes onto x+1 (elif chain of the visit at x)
    w_m9 = (If < -12) & (((-If) & 7) == 6) & incol & (IL == -7)
    neg = If < 0
    w_m8 = ~neg & (If == 8) & (IL == -7) & incol
    w_9 = ~neg & ~(If == 8) & (If > 12) & ((If & 7) >= 6) & incol \
        & (IL == 7)
    # sentinels and escapes never reach the fixup chain
    plain = (If < 10000) & (If >= -10000) & (jnp.abs(If) <= 127)
    wv = jnp.where(w_m9, -9, jnp.where(w_m8, -8, 9))
    wmask = _flat_shift_r(plain & (w_m9 | w_m8 | w_9))
    a = jnp.where(wmask, _flat_shift_r(wv), If)

    # per-position code map on the (possibly rewritten) value
    sent = a > 10000
    escp = a > 127
    escn = a < -127
    selfm8 = (a == -7) & (IL == 8) & incol
    a2 = jnp.where(selfm8, -8, a)
    an = -a2
    dec2 = (an > 14) & ((an & 7) == 7) & (IL > 0) & (IL < 8)
    an = jnp.where(dec2, an - 2, an)
    an = jnp.where((an & 7) < 7, an & 504, an)
    aq = jnp.where(a2 < 0, -an, a2)
    code = jnp.where((aq > -m1) & (aq < m1), 128, (aq + 128) & 248)
    out = jnp.where(sent, _sentinel_code(a),
                    jnp.where(escp | escn, _escape_code(a), code))
    return jnp.where(If == 0, 128, out)


@functools.partial(jax.jit, static_argnames=("m1",))
def offset_y_device(plane, m1: int = 8):
    """ops.quantize.offset_y on a (B,512,512) int16 plane, q > LOW4
    (the duty-cycle-free path; NORM and above plus LOW1..LOW3).
    Bit-exact vs the host C (tests/test_device_scans.py)."""
    If = plane.astype(jnp.int32).reshape(plane.shape[0], -1)
    If = _offset_y_pass1(If)
    p = _offset_y_pass2(If.reshape(plane.shape[0], N, N))
    p = _offset_y_pass3(p)
    out = _offset_y_pass4(p.reshape(plane.shape[0], -1), m1)
    return out.reshape(plane.shape).astype(jnp.int16)


@jax.jit
def offset_uv_device(plane, m2: int = 8):
    """ops.quantize.offset_uv on a (B,256,256) int16 plane.  Fully
    parallel: the 7->8 fixup and the 120-pair greedy are both
    initial-value-pure (see the host docstring analysis), and the
    masking arithmetic's right-neighbour reads are initial values."""
    b = plane.shape[0]
    If = plane.astype(jnp.int32).reshape(b, -1)
    n = If.shape[-1]
    col = jax.lax.broadcasted_iota(jnp.int32, (n,), 0) & 255
    IL = _flat_shift_l(If)
    incol = col < D - 1

    plain = (If <= 10000) & (jnp.abs(If) <= 127)
    # the 7->8 fixup (a > 6, (a&7) >= 6, next == 7).  A fixed 7 becomes
    # 8 and stops triggering, so runs of consecutive 7s alternate from
    # the run head: fixed(h+k) = fixed(h) XOR (k odd), with
    # fixed(h) = a static (non-7) trigger immediately before the run.
    idx = jax.lax.broadcasted_iota(jnp.int32, (n,), 0)
    R = If == 7
    Rp = _flat_shift_r(R, fill=0).astype(bool)
    is_start = R & ~(Rp & (col != 0))
    start = jax.lax.cummax(jnp.where(is_start, idx, -1), axis=1)
    t7 = plain & (If > 6) & ((If & 7) >= 6) & (If != 7)
    fh = is_start & (col != 0) & _flat_shift_r(t7, fill=0).astype(bool)
    fh_at = jnp.take_along_axis(fh.astype(jnp.int32),
                                jnp.maximum(start, 0), axis=1)
    par = (idx - jnp.maximum(start, 0)) & 1
    fixed = R & (start >= 0) & ((fh_at ^ par) == 1)
    v = jnp.where(fixed, 8, If)

    # the 120-pair greedy over current values
    m78 = (v == -7) | (v == -8)
    F = m78 & incol & ((IL == -7) | (IL == -8))
    fired = _run_parity_fire(F)
    consumed = _flat_shift_r(fired)
    is120 = fired | consumed

    a = v
    an = -a
    # C checks pf[i+1] (initial) sign for the mask width
    neg_next = (IL > -8) & (IL < 0)
    keep = jnp.where(neg_next, (an & 7) >= 6, (an & 7) >= 7)
    an_m = jnp.where(keep, an, an & 504)
    aq = jnp.where(a < 0, -an_m, a)
    code = jnp.where((aq > -m2) & (aq < m2), 128, (aq + 128) & 248)

    # only the four mapped sentinels short-circuit; any other >10000
    # value falls through to the escape path (the host dict .get miss)
    sent = ((If == 12400) | (If == 12600) | (If == 12900)
            | (If == 13000))
    sent_code = jnp.where(
        If == 12400, 124, jnp.where(
            If == 12600, 126, jnp.where(
                If == 12900, 122, 130)))
    escp = (If > 127) & ~sent
    escn = If < -127
    out = jnp.where(sent, sent_code,
                    jnp.where(escp | escn, _escape_code(If), code))
    out = jnp.where(is120, 120, out)
    return out.reshape(plane.shape).astype(jnp.int16)


# ---------------------------------------------------------------------------
# E15: serpentine interleave + the stream fixups
# (encoder/nhw_encoder.c:2111-2252; ops/quantize.py serpentine/merge/
#  select/cap)


@functools.lru_cache(maxsize=1)
def _y_serp_inverse():
    import numpy as np

    from nhwcodec_tpu.ops import geometry

    perm = np.asarray(geometry.y_deserpentine_map())
    inv = np.empty(perm.size, np.int32)
    inv[perm] = np.arange(perm.size, dtype=np.int32)
    return inv


@functools.lru_cache(maxsize=1)
def _uv_serp_inverse():
    import numpy as np

    from nhwcodec_tpu.ops import geometry

    perm = np.asarray(geometry.uv_deserpentine_map())
    inv = np.empty(perm.size, np.int32)
    inv[perm] = np.arange(perm.size, dtype=np.int32)
    return inv


def serpentine_y_device(codes):
    """(B,512,512) int16 code plane -> (B, 4*SZ) uint8 stream (the Y
    part of im_nhw; the UV half stays zero until serpentine_uv)."""
    inv = jnp.asarray(_y_serp_inverse())
    flat = (codes.reshape(codes.shape[0], -1) & 255).astype(jnp.uint8)
    return flat[:, inv]


def serpentine_uv_device(codes):
    """(B,256,256) int16 -> (B, SZ) uint8 serpentine stream (the caller
    interleaves U at even / V at odd offsets of im_nhw[4SZ:])."""
    inv = jnp.asarray(_uv_serp_inverse())
    flat = (codes.reshape(codes.shape[0], -1) & 255).astype(jnp.uint8)
    return flat[:, inv]


def _compose5(g, f):
    """Compose packed 5-state maps (3 bits per entry): h(m) = g(f(m))."""
    h = jnp.zeros_like(g)
    for m in range(5):
        fm = (f >> (3 * m)) & 7
        gm = (g >> (3 * jnp.minimum(fm, 4))) & 7
        h = h | (gm << (3 * m))
    return h


_ID5 = 0 | (1 << 3) | (2 << 6) | (3 << 9) | (4 << 12)


def _skip_walk_states(k):
    """Cursor-skip state machine: state m = positions still skipped.
    Per-position map T(m) = m-1 if m>0 else k(i)-1, composed with an
    associative scan; returns the state BEFORE each position (0 =
    visited)."""
    kk = jnp.clip(k - 1, 0, 4)
    t = (kk | (0 << 3) | (1 << 6) | (2 << 9) | (3 << 12)).astype(jnp.int32)
    # prefix composition in walk order: combine(earlier, later) = later∘earlier
    comp = jax.lax.associative_scan(
        lambda a, bb: _compose5(bb, a), t, axis=-1)
    # state before position i = (composition of T_0..T_{i-1})(0)
    before = jnp.concatenate(
        [jnp.zeros_like(comp[..., :1]),
         comp[..., :-1] & 7], axis=-1)
    return before


@jax.jit
def merge_crossing_device(s):
    """ops.quantize.merge_crossing_codes on a (B, >=4*SZ+8) uint8
    stream.  The cursor walk's decisions are initial-value-pure (fires
    write only behind or inside the skip window), so the walk is a
    static 5-state skip machine; fires then apply as masked writes."""
    b, n = s.shape
    v = s.astype(jnp.int32)
    v1 = _flat_shift_l(v)
    v2 = _flat_shift_l(v, 2)
    v3 = _flat_shift_l(v, 3)
    v4 = _flat_shift_l(v, 4)
    idx = jax.lax.broadcasted_iota(jnp.int32, (n,), 0)
    end = 4 * SZ - 4
    c1 = (v != 128) & (v1 == 128)
    pat = c1 & (v2 == 128) & (v3 == 128)
    in01 = ((v == 136) | (v == 120))
    in45 = ((v4 == 136) | (v4 == 120))
    fire_p = pat & in01 & in45
    k = jnp.where(~c1, 1,
                  jnp.where(v2 != 128, 2,
                            jnp.where(v3 != 128, 3,
                                      jnp.where(fire_p, 5, 4))))
    k = jnp.where(idx < end, k, 1)
    before = _skip_walk_states(jnp.broadcast_to(k, (b, n)))
    fire = fire_p & (before == 0) & (idx < end)
    code = jnp.where(v == 136,
                     jnp.where(v4 == 136, 132, 133),
                     jnp.where(v4 == 136, 134, 135))
    out = jnp.where(fire, code, v)
    f4 = _flat_shift_r(fire, 4)
    out = jnp.where(f4, 201, out)
    return out.astype(jnp.uint8)


@jax.jit
def select_codes_device(s):
    """ops.quantize.select_codes: returns (stream', sel1, sel2).  All
    ==128 tests are write-invariant (writes replace one non-128 value
    with another), the nxt reads are initial, and the only chain is
    consumption by the previous candidate's c1/c2 fire — run parity."""
    b, n = s.shape
    idx = jax.lax.broadcasted_iota(jnp.int32, (n,), 0)
    v = s.astype(jnp.int32)
    v = jnp.where((idx < 4) | ((idx >= 4 * SZ - 4) & (idx < 4 * SZ)),
                  128, v)
    e128 = v == 128
    vl1 = _flat_shift_l(v)

    def sr(x, kk):
        return _flat_shift_r(x, kk, False)

    def sl(x, kk):
        return _flat_shift_l(x, kk, False)

    cand = ((v == 136) | (v == 120)) & (idx >= 4) & (idx < 4 * SZ - 4)
    nxt_in = (vl1 == 120) | (vl1 == 136)
    back4 = sr(e128, 1) & sr(e128, 2) & sr(e128, 3) & sr(e128, 4)
    c1 = sl(e128, 2) & nxt_in & back4
    c2 = sr(e128, 1) & nxt_in & sl(e128, 2) & sl(e128, 3) \
        & sl(e128, 4) & sl(e128, 5)
    c3 = back4 & sl(e128, 1)
    c4 = sr(e128, 1) & sl(e128, 1) & sl(e128, 2) & sl(e128, 3) \
        & sl(e128, 4)
    A = cand & (c1 | c2)
    fired12 = _run_parity_fire(A)
    consumed = _flat_shift_r(fired12, 1, False)
    fired34 = cand & ~consumed & ~(c1 | c2) & (c3 | c4)

    out = v
    # c1/c2: write s[i+1] = 157 (nxt == 120) / 159
    w12 = _flat_shift_r(fired12, 1, False)
    code12 = _flat_shift_r(jnp.where(vl1 == 120, 157, 159), 1)
    out = jnp.where(w12, code12, out)
    # c3/c4: write s[i] = 153 (v == 136) / 155
    out = jnp.where(fired34, jnp.where(v == 136, 153, 155), out)
    sel1 = jnp.sum(fired34.astype(jnp.int32), axis=-1)
    sel2 = jnp.sum(fired12.astype(jnp.int32), axis=-1)
    return out.astype(jnp.uint8), sel1, sel2


@jax.jit
def cap_long_runs_device(s):
    """ops.quantize.cap_long_runs: closed-form per maximal 128-run.
    Counting crosses 255 at in-run offsets 255+254m; only the final
    crossing's i+2/i+3 reach past the run end (demoting 153->124 /
    155->123 there), and the residual count >= 252 demotes the first
    post-run byte.  Runs are static (demotes replace non-128 values)."""
    b, n = s.shape
    v = s.astype(jnp.int32)
    idx = jax.lax.broadcasted_iota(jnp.int32, (n,), 0)
    r128 = v == 128
    # maximal 128-runs: start index via cummax, length via end scan
    is_start = r128 & ~_flat_shift_r(r128, 1, False)
    startv = jnp.where(is_start, idx, -1)
    start = jax.lax.cummax(startv, axis=startv.ndim - 1)
    is_end = r128 & ~_flat_shift_l(r128, 1, False)
    # run length at each end position (the pair loop only ENTERS for
    # runs the outer cursor reaches before 4*SZ)
    L = idx - start + 1
    run_ok = is_end & (start < 4 * SZ) & (L >= 2) & (start >= 0)
    # crossings exist while 255+254m <= L-2; the last one's overhang:
    #   i_m == L-2 (m integer)  -> demote at p+L, p+L+1
    #   i_m == L-3              -> demote at p+L
    def is_cross(off):
        return (off >= 255) & (((off - 255) % 254) == 0)

    dem_both = run_ok & is_cross(L - 2)
    dem_one = run_ok & is_cross(L - 3)
    # residual count after M crossings: L-1-254M; M = crossings <= L-2
    M = jnp.where(L >= 257, (L - 257) // 254 + 1, 0)
    res_cnt = L - 1 - 254 * M
    dem_res = run_ok & (res_cnt >= 252)

    # demote masks land at run end + 1 (p+L) and +2 (p+L+1)
    d1 = _flat_shift_r(dem_both | dem_one | dem_res, 1, False)
    d2 = _flat_shift_r(dem_both, 2, False)
    dem = d1 | d2
    out = jnp.where(dem & (v == 153), 124,
                    jnp.where(dem & (v == 155), 123, v))
    return out.astype(jnp.uint8)


# ---------------------------------------------------------------------------
# E12 marking: the res256 column ladder (ops/residue.res256_column_ladder,
# encoder/nhw_encoder.c:1084-1326)
#
# The 256 columns are mutually independent: column j's scan reads only
# its own writes (rows r+1/r+2 of pf column j, its rf column, its band
# row j) plus initial values of column j+1 and rf rows below — EXCEPT
# column 255, whose flat-overflow "pair" reads land on other columns'
# band row heads (pf[(r,256)] = column r's first band value) and on
# rf column 0 (rf[cnt+1] wraps to the next rf row).  So: one lax.scan
# over the 255 rows with columns as lanes, then a corrective re-run of
# column 255 against the main pass's outputs.


def _cl_band_op(case, v, bp):
    """The banded w1/w2/w3/lw5 ops on (bnd_cur, bnd_prev).
    case: 0 none, 1 w1, 2 w2, 3 w3, 4 lw5(res==-4), 5 lw5(res<-6)."""
    neg_ok = (v < -14) & ((((-v) & 7) == 0) | (((-v) & 7) == 7))
    w1 = jnp.where((v == 7) & (bp >= 0) & (bp < 8), v + 2,
                   jnp.where((v == 8) & (bp >= -2) & (bp < 8), v + 2, v))
    w2 = jnp.where(neg_ok, v + 1,
                   jnp.where(((v == 7) | ((v & 65534) == 8))
                             & (bp >= -2), v + 3, v))
    w3 = jnp.where(neg_ok, v + 1,
                   jnp.where((v >= 0) & (((v + 2) & 65532) == 8)
                             & (bp >= -2), 10,
                             jnp.where((v > 14) & ((v & 7) == 7),
                                       v + 1, v)))
    lw4 = jnp.where(((v == -7) | (v == -8)) & (bp > -8) & (bp < 2),
                    -9, v)
    lw6 = jnp.where(neg_ok, v + 1,
                    jnp.where(((v == 7) | (v == 8)) & (bp >= -1)
                              & (bp < 8), v + 3, v))
    return jnp.where(case == 1, w1,
                     jnp.where(case == 2, w2,
                               jnp.where(case == 3, w3,
                                         jnp.where(case == 4, lw4,
                                                   jnp.where(case == 5,
                                                             lw6, v)))))


def _cl_step(flags):
    ge_low1, low2, ge_high1, res_setting = flags

    def step(carry, xs):
        (v0, v1, vprev, markm1, rfc, bnd_prev) = carry
        (i_pf2, i_rf1, i_rf2, i_bnd, p_j1, p1_j1, p2_j1,
         r_j1, r1_j1, r2_j1, has_prev) = xs
        v2 = i_pf2
        res = v0 - rfc
        a = v1 - i_rf1
        b2 = v2 - i_rf2

        mark = rfc                     # rf[cnt] final (default: keep)
        d1 = jnp.zeros_like(v0)        # v1 += d1
        d2 = jnp.zeros_like(v0)        # v2 += d2
        set1 = jnp.zeros_like(v0) - 1  # v1 := value when >= 0 flag
        set1_on = jnp.zeros_like(v0, dtype=bool)
        rf1_new = i_rf1                # rf[cnt+D] (LOW2 writes)
        case = jnp.zeros_like(v0)      # band op selector
        done = jnp.zeros_like(v0, dtype=bool)

        def fire(cond, mk=None, dd1=None, dd2=None, s1=None, rf1=None,
                 bc=None):
            nonlocal mark, d1, d2, set1, set1_on, rf1_new, case, done
            c = cond & ~done
            if mk is not None:
                mark = jnp.where(c, mk, mark)
            if dd1 is not None:
                d1 = jnp.where(c, dd1, d1)
            if dd2 is not None:
                d2 = jnp.where(c, dd2, d2)
            if s1 is not None:
                set1 = jnp.where(c, s1, set1)
                set1_on = set1_on | c
            if rf1 is not None:
                rf1_new = jnp.where(c, rf1, rf1_new)
            if bc is not None:
                case = jnp.where(c, bc, case)
            done = done | cond

        # branch 1
        b = (res == 2) & (a == 2) & (b2 >= 2)
        fire(b & ((b2 < 5) | (b2 > 6)), mk=12400, dd1=-2, dd2=-2)
        done = done | b   # the b2-in-5..6 case does nothing but matched
        # branch 2
        fire((((res == 2) & (a == 3)) | ((res == 3) & (a == 2)))
             & (b2 > 1) & (b2 < 6), mk=12400, dd1=-2, dd2=-2)
        # branch 3
        b3 = (res == 3) & (a == 3)
        fire(b3 & (b2 > 0) & (b2 < 6), mk=12400, dd1=-2, dd2=-2)
        if ge_low1:
            fire(b3, mk=12100, s1=0)   # v1 := rf[cnt+D]
        else:
            done = done | b3
        # branch 4
        b4 = (a == -4) & ((res == 2) | (res == 3)) & ((b2 == 2)
                                                      | (b2 == 3))
        fire(b4 & (res == 2) & (b2 == 2), dd1=1)
        fire(b4, mk=12400, dd1=-2, dd2=-2)
        # branch 5
        b5 = (res == 1) & (a == 3) & (b2 == 2)
        fire(b5 & has_prev & ((vprev - markm1) >= 0),
             mk=12400, dd1=-2, dd2=-2)
        done = done | b5
        # branch 6
        b6 = ((res == 3) | (res == 4) | (res == 5) | (res > 6)) \
            & ((a == 3) | ((a & 65534) == 4))
        fire(b6 & (res > 6), mk=12500, s1=0)
        if ge_low1:
            fire(b6, mk=12100, s1=0)
        elif low2:
            c = b6 & ~done
            rf14 = jnp.where((res < 5) & (a == 5), True,
                             jnp.where(res >= 5, False,
                                       (res == 3) & (a >= 4)))
            hit14 = (res >= 5)
            rf1_new = jnp.where(c & rf14, 14100, rf1_new)
            mark = jnp.where(c & hit14, 14100, mark)
            set1 = jnp.where(c, 0, set1)
            set1_on = set1_on | c
            done = done | b6
        else:
            done = done | b6
        # branch 7 (the cross-column pair check)
        b7 = ((res == 2) | (res == 3)) & ((a == 2) | (a == 3))
        pr = p_j1 - r_j1
        pr1 = p1_j1 - r1_j1
        pr2 = p2_j1 - r2_j1
        fire(b7 & ((b2 == 0) | (b2 == 1))
             & ((pr == 2) | (pr == 3)) & ((pr1 == 2) | (pr1 == 3))
             & (pr2 > 0), mk=12400, dd1=-2, dd2=-2)
        done = done | b7
        # branch 8
        b8 = (a == 4) & ((res == -2) | (res == -3)) \
            & ((b2 == -2) | (b2 == -3))
        fire(b8 & (res == -2) & (b2 == -2), dd1=-1)
        fire(b8, mk=12300, dd1=2, dd2=2)
        # branch 9
        b9 = ((res == -3) | (res == -4) | (res == -5) | (res < -7)) \
            & ((a == -3) | (a == -4) | (a == -5))
        fire(b9 & (res < -7), mk=12600, s1=0)
        if ge_low1:
            fire(b9, mk=12200, s1=0)
        elif low2:
            c = b9 & ~done
            rf14 = jnp.where((res > -5) & (a == -5), True,
                             jnp.where(res <= -5, False,
                                       (res == -3) & (a <= -4)))
            hit14 = (res <= -5)
            rf1_new = jnp.where(c & rf14, 14000, rf1_new)
            mark = jnp.where(c & hit14, 14000, mark)
            set1 = jnp.where(c, 0, set1)
            set1_on = set1_on | c
            done = done | b9
        else:
            done = done | b9
        # branch 10: a in (-2, -3)
        b10 = (a == -2) | (a == -3)
        g = b10 & ~done
        r23 = (res == -2) | (res == -3)
        fire(g & r23 & (b2 < 0), mk=12300, dd1=2, dd2=2)
        if ge_high1:
            fire(g & r23 & (res == -3), mk=14500)
        npair = ((pr == -2) | (pr == -3)) & ((pr1 == -2) | (pr1 == -3)) \
            & (pr2 < 0)
        fire(g & r23 & (b2 == 0) & npair, mk=12300, dd1=2, dd2=2)
        fire(g & r23 & (b2 == 0), )    # matched, no action
        fire(g & r23 & (res == -2), bc=2)
        if ge_high1:
            fire(g & r23, mk=14500)    # _lw3
        else:
            fire(g & r23, bc=3)
        b10b = g & (res == -1) & (a == -3) & (b2 == -2)
        fire(b10b & has_prev & ((vprev - markm1) <= 0),
             mk=12300, dd1=2, dd2=2)
        done = done | b10b
        fire(g & (res == -1) & (b2 == -3), mk=12300, dd1=2, dd2=2)
        fire(g & (res == -1), bc=1)
        b10d = g & (res == -4)
        fire(b10d & (b2 <= -2) & (b2 >= -3), mk=12300, dd1=2, dd2=2)
        # _lw5(res == -4): mark 14000 + band case 4
        fire(b10d, mk=14000, bc=4)
        done = done | b10
        # branches 11-14
        fire(((res == 0) | (res == -1)), bc=1)
        fire((res == -2), bc=2)
        if ge_high1:
            fire((res == -3), mk=14500)
        else:
            fire((res == -3), bc=3)
        # _lw5 tail: res < -res_setting
        blast = res < -res_setting
        c0 = blast & ~done
        mark = jnp.where(c0, 14000, mark)        # _lw5 sets 14000 first
        case = jnp.where(c0 & (res == -4), 4, case)
        if ge_high1:
            mark = jnp.where(c0 & (res < -7), 14900, mark)
            case = jnp.where(c0 & (res < -6) & ~(res < -7), 5, case)
        else:
            case = jnp.where(c0 & (res < -6), 5, case)
        done = done | blast

        v1f = jnp.where(set1_on, rf1_new, v1 + d1)
        v2f = v2 + d2
        bnd = _cl_band_op(case, i_bnd, bnd_prev)
        carry2 = (v1f, v2f, v0, mark, rf1_new, bnd)
        return carry2, (v0, mark, bnd)

    return step


@functools.partial(jax.jit, static_argnames=("flags",))
def _cl_main(plane, rf_ext, flags):
    """Main column-ladder scan over all 256 columns as lanes."""
    b = plane.shape[0]
    I = plane.astype(jnp.int32)
    rfe = rf_ext.astype(jnp.int32)
    rows = jnp.arange(255)

    def gather_rows(r_off):
        # (255, B, 256): plane rows r+r_off, columns 0..255
        return jnp.swapaxes(
            jax.lax.dynamic_slice_in_dim(I, r_off, 255, axis=1),
            0, 1)[:, :, :256]

    def rf_rows(r_off):
        sl = jax.lax.dynamic_slice_in_dim(
            rfe, r_off * 256, 255 * 256, axis=1).reshape(b, 255, 256)
        return jnp.swapaxes(sl, 0, 1)

    def rf_rows_sh(r_off):
        # rf[r*256 + j + 1 + r_off*256] — the flat +1 (column j+1,
        # wrapping to the next row's column 0 at j=255)
        sl = jax.lax.dynamic_slice_in_dim(
            rfe, r_off * 256 + 1, 255 * 256, axis=1).reshape(b, 255, 256)
        return jnp.swapaxes(sl, 0, 1)

    def pf_rows_sh(r_off):
        # plane[r+r_off, j+1] (col 256 read for j=255 — corrected later)
        sl = jax.lax.dynamic_slice_in_dim(I, r_off, 255, axis=1)
        return jnp.swapaxes(sl[:, :, 1:257], 0, 1)

    i_bnd = jnp.swapaxes(I[:, :256, 256:511], 0, 2).swapaxes(1, 2)
    # i_bnd[r, b, j] = I[b, j, 256+r]
    xs = (gather_rows(2), rf_rows(1), rf_rows(2), i_bnd,
          pf_rows_sh(0), pf_rows_sh(1), pf_rows_sh(2),
          rf_rows_sh(0), rf_rows_sh(1), rf_rows_sh(2),
          rows > 0)
    init = (I[:, 0, :256], I[:, 1, :256],
            jnp.zeros((b, 256), jnp.int32), jnp.zeros((b, 256), jnp.int32),
            rfe[:, :256], I[:, :256, 255])
    carry, ys = jax.lax.scan(_cl_step(flags), init, xs)
    return carry, ys


@functools.partial(jax.jit, static_argnames=("flags",))
def _cl_col255(plane, rf_ext, bnd0_all, bnd0_255, rf_col0, flags):
    """Corrective re-run of column 255: its pair reads see the other
    columns' first band values (bnd0_all[j] = final plane[j, 256]) and
    rf column 0's final marks; its own first band value feeds steps
    253-254 (bnd0_255, fixed by running this twice)."""
    b = plane.shape[0]
    I = plane.astype(jnp.int32)
    rfe = rf_ext.astype(jnp.int32)
    rows = jnp.arange(255)
    j = 255

    p_j1 = jnp.swapaxes(bnd0_all[:, 0:255], 0, 1)[:, :, None]
    # rows r+1: (r+1, 256) = bnd0_all for rows 1..254, own bnd0 at 255
    p1_j1 = jnp.swapaxes(
        jnp.concatenate([bnd0_all[:, 1:255],
                         bnd0_255[:, None]], axis=1), 0, 1)[:, :, None]
    # rows r+2: bnd0_all for rows 2..254, own bnd0 at 255, and the
    # untouched initial plane value at row 256
    tail = jnp.concatenate([bnd0_all[:, 2:255],
                            bnd0_255[:, None],
                            I[:, 256, 256][:, None]], axis=1)
    p2_j1 = jnp.swapaxes(tail, 0, 1)[:, :, None]
    # rf col 0 rows r..r+2 final (rf[cnt+1] wraps to row r+1 col 0)
    r_j1 = jnp.swapaxes(rf_col0[:, 1:256], 0, 1)[:, :, None]
    r1_j1 = jnp.swapaxes(rf_col0[:, 2:257], 0, 1)[:, :, None]
    r2_j1 = jnp.swapaxes(rf_col0[:, 3:258], 0, 1)[:, :, None]

    def col(r_off):
        return jnp.swapaxes(jax.lax.dynamic_slice_in_dim(
            I[:, :, j], r_off, 255, axis=1), 0, 1)[:, :, None]

    def rfc_rows(r_off):
        # strided gather of rf[(r+r_off)*256 + 255]
        idx = ((rows + r_off) * 256 + j)
        return jnp.swapaxes(rfe[:, idx], 0, 1)[:, :, None]

    i_bnd = jnp.swapaxes(I[:, j, 256:511], 0, 1)[:, :, None]
    xs = (col(2), rfc_rows(1), rfc_rows(2), i_bnd,
          p_j1, p1_j1, p2_j1, r_j1, r1_j1, r2_j1, rows > 0)
    init = (I[:, 0, j][:, None], I[:, 1, j][:, None],
            jnp.zeros((b, 1), jnp.int32), jnp.zeros((b, 1), jnp.int32),
            rfe[:, j][:, None], I[:, j, 255][:, None])
    carry, ys = jax.lax.scan(_cl_step(flags), init, xs)
    return carry, ys


def column_ladder_device(plane, rf_ext, quality: int, res_setting: int):
    """ops.residue.res256_column_ladder on (B,512,512) int16 planes.
    rf_ext: (B, SZ+1024) int16 (res256 + the oob tail the host builds).
    Returns (plane', rf') with rf' of shape (B, SZ)."""
    from nhwcodec_tpu import tables as T

    flags = (quality >= T.LOW1, quality == T.LOW2,
             quality >= T.HIGH1, res_setting)
    plane = jnp.asarray(plane)
    rf_ext = jnp.asarray(rf_ext)
    b = plane.shape[0]
    carry, ys = _cl_main(plane, rf_ext, flags)
    v0s, marks, bnds = ys            # (255, B, 256)

    out = plane.astype(jnp.int32)
    out = out.at[:, 0:255, 0:256].set(jnp.swapaxes(v0s, 0, 1))
    out = out.at[:, 255, 0:256].set(carry[0])
    out = out.at[:, 256, 0:256].set(carry[1])
    out = out.at[:, 0:256, 256:511].set(
        jnp.swapaxes(jnp.swapaxes(bnds, 0, 1), 1, 2))
    rf = rf_ext.astype(jnp.int32)[:, :SZ].reshape(b, 256, 256)
    rf = rf.at[:, 0:255, :].set(jnp.swapaxes(marks, 0, 1))
    rf = rf.at[:, 255, :].set(carry[4])

    # column 255 correction (two passes: the second resolves its own
    # step-0 band value feeding steps 253-254)
    bnd0_all = out[:, 0:256, 256]                    # final (j, 256)
    # rf column 0 rows 0..255 final, then the flat-overflow tail the
    # reference reads at rf[65536] / rf[65792] (the oob block)
    rfe32 = rf_ext.astype(jnp.int32)
    rf_col0 = jnp.concatenate(
        [rf[:, :, 0], rfe32[:, SZ][:, None],
         rfe32[:, SZ + 256][:, None]], axis=1)
    bnd0_255 = out[:, 255, 256]
    for _ in range(2):
        carry2, ys2 = _cl_col255(plane, rf_ext, bnd0_all, bnd0_255,
                                 rf_col0, flags)
        bnd0_255 = ys2[2][0, :, 0]
    v0s2, marks2, bnds2 = ys2
    out = out.at[:, 0:255, 255].set(v0s2[:, :, 0].T)
    out = out.at[:, 255, 255].set(carry2[0][:, 0])
    out = out.at[:, 256, 255].set(carry2[1][:, 0])
    out = out.at[:, 255, 256:511].set(jnp.swapaxes(bnds2[:, :, 0], 0, 1))
    rf = rf.at[:, 0:255, 255].set(marks2[:, :, 0].T)
    rf = rf.at[:, 255, 255].set(carry2[4][:, 0])
    return (out.astype(jnp.int16),
            rf.reshape(b, SZ).astype(jnp.int16))


# ---------------------------------------------------------------------------
# E12 classify: residue codes 121..149 (ops/residue.res256_classify,
# encoder/nhw_encoder.c:1329-1420).  Row-major raster, but pf[scan] and
# rf[cnt] reads are initial-value-pure; the only chain is each band
# row's st-1 read of the previous outer row's write — a 256-step scan
# over rows with columns as lanes.


def _classify_step(flags):
    ge_high1, res_setting = flags

    def step(bnd_prev, xs):
        pf_r, rf_r, i_bnd = xs
        mark = rf_r
        low = mark < 12000
        res = pf_r - mark

        v = i_bnd
        bp = bnd_prev
        case_nop = v             # untouched-band default

        # band helpers
        dec16 = (v > 15) & ((v & 7) == 0)
        m78 = (v == -7) | (v == -8)

        b01 = low & ((res == 0) | (res == 1))
        bA = jnp.where(m78 & (bp > -8) & (bp < 2), -9, v)
        b2m = low & (res == 2)
        bB = jnp.where(dec16, v - 1,
                       jnp.where(m78 & (bp <= 1), -9,
                                 jnp.where((v == -6) & (bp > -8)
                                           & (bp <= -1), -9, v)))
        b3m = low & (res == 3)
        bC = jnp.where(dec16, v - 1,
                       jnp.where((v <= 0) & ((((-v) + 2) & 65532) == 8)
                                 & (bp <= 2), -10, v))
        bhi = low & (res > res_setting)
        bD = jnp.where(((v == 7) | ((v & 65534) == 8)) & (bp >= 0)
                       & (bp < 8), v + 2, v)
        bE = jnp.where(dec16, v - 1,
                       jnp.where(((v == -6) | (v == -7) | (v == -8))
                                 & (bp > -8) & (bp < 0), -9, v))

        if ge_high1:
            r148 = bhi & (res > 6) & (res > 7)
            bnd = jnp.where(b01, bA,
                            jnp.where(b2m, bB,
                                      jnp.where(bhi & (res == 4), bD,
                                                jnp.where(bhi & (res > 6)
                                                          & ~r148, bE,
                                                          case_nop))))
            rf_new = jnp.where(b3m, 144,
                               jnp.where(r148, 148,
                                         jnp.where(bhi, 141,
                                                   jnp.where(low, 0,
                                                             mark))))
        else:
            bnd = jnp.where(b01, bA,
                            jnp.where(b2m, bB,
                                      jnp.where(b3m, bC,
                                                jnp.where(bhi & (res == 4),
                                                          bD,
                                                          jnp.where(
                                                              bhi
                                                              & (res > 6),
                                                              bE,
                                                              case_nop)))))
            rf_new = jnp.where(bhi, 141, jnp.where(low, 0, mark))

        # mark-path code map
        hi = ~low
        code = jnp.where(
            mark == 14000, 140, jnp.where(
                mark == 14500, 145, jnp.where(
                    mark == 12200, 122, jnp.where(
                        mark == 12100, 121, jnp.where(
                            mark == 12300, 123, jnp.where(
                                mark == 12400, 124, jnp.where(
                                    mark == 14100, 141, jnp.where(
                                        mark == 12500, 125, jnp.where(
                                            mark == 12600, 126,
                                            149)))))))))
        rf_new = jnp.where(hi, code, rf_new)

        n1 = (jnp.where(b3m & jnp.bool_(ge_high1), 0, 0)
              + bhi.astype(jnp.int32)
              + ((bhi & (res > 6) & (res > 7)).astype(jnp.int32)
                 if ge_high1 else 0)
              + (hi & ((code == 140) | (code == 141) | (code == 125)
                       | (code == 126) | (code == 149))).astype(jnp.int32))
        n3 = (hi & ((code == 122) | (code == 121) | (code == 123)
                    | (code == 124) | (code == 125)
                    | (code == 126))).astype(jnp.int32)
        n5 = (((b3m.astype(jnp.int32)
                + (bhi & (res > 6) & (res > 7)).astype(jnp.int32))
               if ge_high1 else jnp.zeros_like(res))
              + (hi & ((code == 145) | (code == 149))).astype(jnp.int32))
        stats = jnp.stack([jnp.sum(n1, -1), jnp.sum(n3, -1),
                           jnp.sum(n5, -1)], -1)
        return bnd, (rf_new, bnd, stats)

    return step


def classify_device(plane, res256, quality: int, res_setting: int):
    """ops.residue.res256_classify on (B,512,512) planes + (B,256,256)
    res256.  Returns (plane', res256', n1, n3, n5)."""
    from nhwcodec_tpu import tables as T

    plane = jnp.asarray(plane)
    res256 = jnp.asarray(res256)
    flags = (quality >= T.HIGH1, res_setting)
    I = plane.astype(jnp.int32)
    rf = res256.astype(jnp.int32)
    # xs[r]: pf row r cols 0..255, rf row r, band value (j, 256+r)
    xs = (jnp.swapaxes(I[:, :256, :256], 0, 1),
          jnp.swapaxes(rf, 0, 1),
          jnp.swapaxes(I[:, :256, 256:512], 0, 2).swapaxes(1, 2))
    bnd0 = I[:, :256, 255]
    _, (rf_out, bnd_out, stats) = jax.lax.scan(
        _classify_step(flags), bnd0, xs)
    out = I.at[:, :256, 256:512].set(
        jnp.swapaxes(jnp.swapaxes(bnd_out, 0, 1), 1, 2))
    rf2 = jnp.swapaxes(rf_out, 0, 1)
    tot = jnp.sum(stats, axis=0)       # (B, 3)
    return (out.astype(jnp.int16), rf2.astype(jnp.int16),
            tot[:, 0], tot[:, 1], tot[:, 2])


# ---------------------------------------------------------------------------
# E12 streams: positional side-stream build + finish
# (ops/residue.build_positional_stream / dedupe_markers /
#  delta_pair_pack / _pack_bits / finish_stream)

P_MAX = SZ + 512


def _compact(mask, vals, fill, size):
    """Rank-compact vals[mask] into a (B, size) buffer (row-major
    order preserved); returns (buf, counts)."""
    b, n = mask.shape
    vals = jnp.broadcast_to(vals, mask.shape)
    rank = jnp.cumsum(mask.astype(jnp.int32), axis=1) - mask
    rowO = (jnp.arange(b, dtype=jnp.int32) * size)[:, None]
    seq = jnp.arange(b * n, dtype=jnp.int32).reshape(b, n)
    idx = jnp.where(mask & (rank < size), rank + rowO,
                    b * size + seq).reshape(-1)
    buf = jnp.full(b * size, fill, vals.dtype)
    buf = buf.at[idx].set(vals.reshape(-1), mode="drop",
                          unique_indices=True)
    cnt = jnp.sum(mask.astype(jnp.int32), axis=1)
    return buf.reshape(b, size), cnt


@functools.partial(jax.jit, static_argnames=("word_bits",))
def positional_stream_device(rf, wt, rt, word_bits: int):
    """build_positional_stream + finish_stream on a (B,256,256) int16
    post-classify res256.  Returns (rf', packed, n_packed, bit_bytes,
    n_nonmarker, word_bytes, n_words); the host slices the sections by
    the counts ((n>>3)+1 block sizing as in the C)."""
    b = rf.shape[0]
    code = rf.astype(jnp.int32).reshape(b, SZ)
    jcol = jax.lax.broadcasted_iota(jnp.int32, (SZ,), 0) & 255
    wt = jnp.asarray(wt, jnp.int32)
    rt = jnp.asarray(rt, jnp.int32)
    in_tab = (code >= 0) & (code < 256)
    cw = wt[jnp.clip(code, 0, 255)]
    is_code = in_tab & (cw >= 0) & (jcol < D - 2)
    marker = jcol == D - 2
    emit = marker | is_code
    pos_val = jnp.where(marker, D - 2, jcol)
    rf_new = jnp.where(is_code, rt[jnp.clip(code, 0, 255)], code)
    rf_new = jnp.where(marker | (jcol == D - 1), 0, rf_new)

    pos, npos = _compact(emit, pos_val, jnp.int32(1 << 20), P_MAX)
    wvals = cw
    wmask = is_code
    words, nwords = _compact(wmask, wvals, jnp.int32(0), SZ)

    # dedupe isolated ascending-neighbour markers
    idx = jax.lax.broadcasted_iota(jnp.int32, (P_MAX,), 0)
    prev = _flat_shift_r(pos, 1, 1 << 20)
    nxt = _flat_shift_l(pos, 1, 1 << 20)
    mid = (idx >= 1) & (idx < (npos - 1)[:, None])
    drop = mid & (pos == D - 2) & (prev != D - 2) & (nxt != D - 2) \
        & (prev > nxt)
    keep = (idx < npos[:, None]) & ~drop
    ded, nded = _compact(keep, pos, jnp.int32(1 << 20), P_MAX)

    # delta pair pack: 2-state skip walk over the deduped list
    sr = ded >> 1
    d1 = sr - _flat_shift_r(sr, 1, 0)
    d2 = _flat_shift_l(sr, 1, 0) - sr
    pair = (d1 >= 0) & (d1 < 8) & (d2 >= 0) & (d2 < 16) & (idx >= 1)
    k = jnp.where(pair, 2, 1)
    before = _skip_walk_states(k)
    live = idx < (nded - 1)[:, None]
    emit2 = (idx == 0) | ((before == 0) & (idx >= 1) & live)
    byte = jnp.where(idx == 0, sr,
                     jnp.where(pair, 128 + (d1 << 4) + d2, sr))
    packed, npacked = _compact(emit2, byte, jnp.int32(0), P_MAX)

    # bit plane of non-marker positions (LSBs, 8 per byte)
    nm = (ded != D - 2) & (idx < nded[:, None])
    nmv, n_nm = _compact(nm, ded & 1, jnp.int32(0), P_MAX)
    bits = nmv.reshape(b, P_MAX // 8, 8)
    w8 = (jnp.arange(8, dtype=jnp.int32))[::-1]
    bit_bytes = jnp.sum(bits << w8, axis=2).astype(jnp.uint8)

    # word plane (1- or 2-bit entries)
    wb = words.reshape(b, SZ // 8, 8)
    if word_bits == 1:
        word_bytes = jnp.sum((wb & 1) << w8, axis=2).astype(jnp.uint8)
    else:
        w4 = (2 * jnp.arange(4, dtype=jnp.int32))[::-1]
        b1 = jnp.sum((wb[:, :, :4] & 3) << w4, axis=2)
        b2 = jnp.sum((wb[:, :, 4:] & 3) << w4, axis=2)
        word_bytes = jnp.stack([b1, b2], axis=2).reshape(
            b, SZ // 4).astype(jnp.uint8)

    return (rf_new.reshape(b, D, D).astype(jnp.int16), packed, npacked,
            bit_bytes, n_nm, word_bytes, nwords)


# ---------------------------------------------------------------------------
# UV scans: compare ladder, sentinel marking, LL2 byte-coding
# (models/encoder._uv_compare_ladder / _uv_sentinel_marking /
#  encode_uv's LL2 loop; encoder/nhw_encoder.c:2316-2536)


@functools.partial(jax.jit, static_argnames=("strict",))
def uv_compare_ladder_device(jpeg, process, res256, oob0, strict: bool):
    """(B,256,256) jpeg/process + (B,128,128) res256 + per-image oob0
    scalar; writes the 128x128 LL quadrant of jpeg.  Fully parallel:
    every read is an initial value."""
    p = process.astype(jnp.int32)[:, :128, :128]
    rfl = res256.astype(jnp.int32).reshape(res256.shape[0], -1)
    r = rfl.reshape(-1, 128, 128)
    # next LL position (flat e+1 crosses into col 128 of process at
    # j=127; rf cnt+1 crosses rows, oob0 at the last)
    pe1 = process.astype(jnp.int32)[:, :128, 1:129]
    rn = jnp.concatenate([rfl[:, 1:], oob0.astype(jnp.int32)[:, None]],
                         axis=1).reshape(-1, 128, 128)
    scan = p - r
    nxt = pe1 - rn
    pos_edge = (nxt > 0) if strict else (nxt >= 0)
    neg_edge = (nxt < 0) if strict else (nxt <= 0)
    k = jnp.where(scan > 10, -6, jnp.where(
        scan > 7, -3, jnp.where(
            scan > 4, -2, jnp.where(
                scan > 3, -1, jnp.where(
                    (scan > 2) & pos_edge, -1, jnp.where(
                        scan < -10, 6, jnp.where(
                            scan < -7, 3, jnp.where(
                                scan < -4, 2, jnp.where(
                                    scan < -3, 1, jnp.where(
                                        (scan < -2) & neg_edge,
                                        1, 0))))))))))
    out = (r + k).astype(jnp.int16)
    return jpeg.at[:, :128, :128].set(out)


def _uvsm_row(res_uv: int):
    def decide(d0, d1, band0, band1, band2):
        pos_pair = (d0 > 3) & (d0 < 7) & (d1 > 2) & (d1 < 7)
        neg_pair = (d0 > -7) & (d0 < -3) & (d1 > -8) & (d1 < -2)
        free0 = jnp.abs(band0) < 8
        free1 = jnp.abs(band1) < 8
        free2 = jnp.abs(band2) < 8
        placed_pair = (pos_pair | neg_pair) & (free0 | free1 | free2)
        big = jnp.abs(d0) > res_uv
        code_s = jnp.where(d0 > 0, 12900,
                           jnp.where(d0 == -5,
                                     jnp.where(d1 < 0, 13000, 0),
                                     13000))
        return (pos_pair, placed_pair, big, code_s,
                free0, free1, free2)

    def apply(visited, pos_pair, placed_pair, big, code_s,
              free0, free1, free2, band0, band1, band2):
        fire_pair = placed_pair & visited
        fire_s = visited & ~placed_pair & big & (code_s != 0)
        code = jnp.where(fire_pair,
                         jnp.where(pos_pair, 12400, 12600), code_s)
        fire = fire_pair | fire_s
        sel0 = fire & free0
        sel1 = fire & ~free0 & free1
        sel2 = fire & ~free0 & ~free1 & free2
        w0 = jnp.where(sel0, code, band0)
        w1 = jnp.where(sel1, code, band1)
        w2 = jnp.where(sel2, code, band2)
        return fire_pair, w0, w1, w2

    def row(count_start, xs):
        pf_row, band0, band1, band2, rf_base = xs
        sl = jax.vmap(lambda rfb, cs: jax.lax.dynamic_slice(
            rfb, (cs,), (130,)))(rf_base, count_start)
        d0 = pf_row[:, :128] - sl[:, :128]
        d1 = pf_row[:, 1:129] - sl[:, 1:129]
        (pos_pair, placed_pair, big, code_s,
         f0, f1, f2) = decide(d0, d1, band0, band1, band2)
        k = jnp.where(placed_pair, 2, 1)
        before = _skip_walk_states(k)
        visited = before == 0
        fire_pair, w0, w1, w2 = apply(
            visited, pos_pair, placed_pair, big, code_s,
            f0, f1, f2, band0, band1, band2)
        # lane 127's d1 read (flat scan+1) lands on this row's OWN
        # first band slot, which lane 0 may just have written — patch
        # lane 127 against the updated value
        d1c = w0[:, 0] - sl[:, 128]
        (pp_c, plp_c, big_c, cs_c, f0c, f1c, f2c) = decide(
            d0[:, 127], d1c, band0[:, 127], band1[:, 127],
            band2[:, 127])
        fp_c, w0c, w1c, w2c = apply(
            visited[:, 127], pp_c, plp_c, big_c, cs_c,
            f0c, f1c, f2c, band0[:, 127], band1[:, 127],
            band2[:, 127])
        w0 = w0.at[:, 127].set(w0c)
        w1 = w1.at[:, 127].set(w1c)
        w2 = w2.at[:, 127].set(w2c)
        count_next = count_start + 128 + fp_c.astype(jnp.int32)
        return count_next, (w0, w1, w2)
    return row


def uv_sentinel_marking_device(process, rf_ext, res_uv: int):
    """_uv_sentinel_marking on (B,256,256) process planes.
    rf_ext: (B, 16384+512) int16 (res256 + zero/oob tail).  The count
    register drifts at row-end pair placements; each row is a static
    2-state skip walk given its count_start, so the pass is a 128-step
    scan over rows (the only in-row write feedback is lane 127's flat
    d1 read of the row's first band slot, patched per row)."""
    process = jnp.asarray(process)
    b = process.shape[0]
    p = process.astype(jnp.int32).reshape(b, -1)
    rfb = jnp.asarray(rf_ext).astype(jnp.int32)
    pf_rows = jnp.swapaxes(
        p[:, : 128 * 256].reshape(b, 128, 256)[:, :, :130], 0, 1)
    half = SZ >> 1
    pp = jnp.concatenate([p, jnp.zeros((b, 256), jnp.int32)], axis=1)

    def seg(off):
        return jnp.swapaxes(
            pp[:, off: off + 128 * 256].reshape(b, 128, 256)[:, :, :128],
            0, 1)

    band0, band1, band2 = seg(128), seg(half), seg(half + 128)
    rfB = jnp.broadcast_to(rfb[None], (128,) + rfb.shape)
    xs = (pf_rows, band0, band1, band2, rfB)
    cnt0 = jnp.zeros((b,), jnp.int32)
    _, (w0, w1, w2) = jax.lax.scan(_uvsm_row(res_uv), cnt0, xs)

    # bands 0/1/2 live at flat offsets 128 / half / half+128 with row
    # stride 256 — the (256,256) view quadrants
    full = p.reshape(b, 256, 256)
    full = full.at[:, 0:128, 128:256].set(jnp.swapaxes(w0, 0, 1))
    full = full.at[:, 128:256, 0:128].set(jnp.swapaxes(w1, 0, 1))
    full = full.at[:, 128:256, 128:256].set(jnp.swapaxes(w2, 0, 1))
    return full.astype(jnp.int16)


@jax.jit
def ll2_code_uv_device(process):
    """encode_uv's LL2 byte-coding loop: 64x64 -> tree1_uv[4096] +
    exw triples + zeroed quadrant.  a_out always advances by 1, so
    tree1 indices are static; escapes take the last non-escape value
    (a segmented fill).  Returns (process', tree1_uv, exw_buf(B,N,3),
    n_exw)."""
    b = process.shape[0]
    p = process.astype(jnp.int32)
    v = p[:, :64, :64].reshape(b, 4096)
    idx = jax.lax.broadcasted_iota(jnp.int32, (4096,), 0)
    esc_p = (v > 255) & (idx > 0)
    esc_n = (v < 0) & (idx > 0)
    esc = esc_p | esc_n
    clip = jnp.clip(v, 0, 255)
    plain_val = clip & 254
    # last non-escape value at or before k-1
    src = jax.lax.cummax(jnp.where(~esc, idx, -1), axis=1)
    prev_src = jnp.concatenate(
        [jnp.zeros((b, 1), jnp.int32), src[:, :-1]], axis=1)
    fillv = jnp.take_along_axis(plain_val, jnp.maximum(prev_src, 0),
                                axis=1)
    tree1 = jnp.where(esc, fillv, plain_val).astype(jnp.uint8)
    rr = jnp.broadcast_to(idx >> 6, esc.shape)
    jj = idx & 63
    ev = jnp.stack([rr, jnp.where(esc_p, jj + 128, jj),
                    jnp.where(esc_p, jnp.minimum(v - 255, 255),
                              -jnp.maximum(v, -255))], axis=-1)
    exw, n_exw = _compact(esc, ev[..., 0] * 0 + 1, jnp.int32(0), 4096)
    # compact the triples: flatten (B, 4096, 3) by escape mask
    rank = jnp.cumsum(esc.astype(jnp.int32), axis=1) - esc
    rowO = (jnp.arange(b, dtype=jnp.int32) * 4096)[:, None]
    seq = jnp.arange(b * 4096, dtype=jnp.int32).reshape(b, 4096)
    tgt = jnp.where(esc, rank + rowO, b * 4096 + seq).reshape(-1)
    buf = jnp.zeros((b * 4096, 3), jnp.int32)
    buf = buf.at[tgt].set(ev.reshape(-1, 3), mode="drop",
                          unique_indices=True)
    out = p.at[:, :64, :64].set(0)
    return (out.astype(jnp.int16), tree1.reshape(b, 4096),
            buf.reshape(b, 4096, 3), n_exw)


# ---------------------------------------------------------------------------
# E17: UV LL2 run/delta compression (ops/ll2.uv_highres_compression,
# encoder/compress_pixel.c:878-1022) — a static-successor walk over the
# immutable h buffer, resolved with pointer doubling.


def _walk_visited(nxt, start: int = 1):
    """Visited mask of the monotone walk start -> nxt[start] -> ... over
    (B, n) successor arrays (nxt[i] > i), via pointer doubling: each
    round ORs the current frontier's 2^k-jump targets into the visited
    set and squares the jump table.  All walks here are forward-
    monotone, so visit order equals index order."""
    b, n = nxt.shape
    J = jnp.clip(nxt, 0, n)                      # n = parked self-loop
    Jext = jnp.concatenate([J, jnp.full((b, 1), n, jnp.int32)], axis=1)
    visited = jnp.zeros((b, n + 1), bool).at[:, start].set(True)
    rowO = (jnp.arange(b, dtype=jnp.int32) * (n + 1))[:, None]
    k = 1
    while k < n:
        flat = jnp.where(visited, Jext + rowO,
                         b * (n + 1)).reshape(-1)
        upd = jnp.zeros(b * (n + 1), bool).at[flat].max(
            jnp.ones_like(flat, dtype=bool), mode="drop")
        visited = visited | upd.reshape(b, n + 1)
        Jext = jnp.take_along_axis(Jext, Jext, axis=1)
        k <<= 1
    return visited[:, :n]


@jax.jit
def uv_highres_device(h):
    """(B, 8192+80) int32 (&252-masked UV tree plane + oob tail) ->
    (bytes buffer (B, 8192+8), count).  Every branch emits exactly one
    byte; the walk successor and emissions are pure functions of h."""
    b, npad = h.shape
    n = 8192
    idx = jax.lax.broadcasted_iota(jnp.int32, (npad,), 0)
    hm1 = _flat_shift_r(h, 1, 0)
    h1 = _flat_shift_l(h, 1, 0)
    h2 = _flat_shift_l(h, 2, 0)
    scan = h - hm1
    count = h1 - h
    # E[i]: streak of equal pairs starting at k = i+1
    # (eq[k] = h[k+1] == h[k]); next-false via reverse cummin
    eq = h1 == h
    nf = jax.lax.cummin(
        jnp.where(~eq, idx, 1 << 20)[:, ::-1], axis=1)[:, ::-1]
    E = jnp.take_along_axis(
        jnp.concatenate([nf, jnp.full((b, 1), 1 << 20, jnp.int32)],
                        axis=1),
        jnp.minimum(idx + 1, npad - 1)[None].repeat(b, 0), axis=1) \
        - (idx + 1)
    E = jnp.clip(E, 0, 1 << 19)

    runb = (scan == 0) & (count == 0)
    a_run = jnp.minimum(E, 14)
    res1 = a_run >= 7
    base = idx + a_run + 2

    baseB = base
    def gatb(off):
        return jnp.take_along_axis(
            h, jnp.clip(baseB + off, 0, npad - 1), axis=1)

    d1 = gatb(0) - gatb(-1)
    d2 = gatb(1) - gatb(0)
    d3 = gatb(2) - gatb(1)
    code0 = 64 + (a_run << 3)
    run_code = jnp.where(
        d1 == 4, jnp.where(d2 == -4, jnp.where(d3 == 0, code0 + 3,
                                               code0 + 2), code0 + 1),
        jnp.where(d1 == -4,
                  jnp.where(d2 == 4, jnp.where(d3 == 0, code0 + 4,
                                               code0 + 5), code0 + 6),
                  jnp.where(d1 == 8, code0 + 7, code0)))
    run_adv = jnp.where(
        d1 == 4, jnp.where(d2 == -4, jnp.where(d3 == 0, 3, 2), 1),
        jnp.where(d1 == -4,
                  jnp.where(d2 == 4, jnp.where(d3 == 0, 3, 2), 1),
                  jnp.where(d1 == 8, 1, 0)))
    run_nxt = jnp.where(res1, base, baseB + run_adv)
    run_emit = jnp.where(res1, 64 + 56 + a_run - 7, run_code)

    # non-run branches
    in4 = (jnp.abs(scan) <= 4) & (jnp.abs(count) <= 4)
    resv = jnp.where(
        (scan == 0) & (count == 4), 0, jnp.where(
            (scan == 0) & (count == -4), 1, jnp.where(
                (scan == 4) & (count == 0), 2, jnp.where(
                    (scan == -4) & (count == 0), 3, jnp.where(
                        (scan == 4) & (count == 4), 4, jnp.where(
                            (scan == 4) & (count == -4), 5, jnp.where(
                                (scan == -4) & (count == 4), 6,
                                jnp.where((scan == -4) & (count == -4),
                                          7, 0))))))))
    dd3 = h2 - h1
    quad = (dd3 == 0) | (dd3 == 4) | (dd3 == -4) | (dd3 == 8)
    q_add = jnp.where(dd3 == 0, 0, jnp.where(dd3 == 4, 1,
                                             jnp.where(dd3 == -4, 2,
                                                       3)))
    s16 = scan + 16
    c16 = count + 16
    pair_b = (s16 << 1) + (c16 >> 2)
    in16 = (jnp.abs(scan) <= 16) & (jnp.abs(count) <= 16)
    esc16 = (s16 == 32) | (c16 == 32)
    nr_emit = jnp.where(
        in4, jnp.where(quad, 192 + (resv << 2) + q_add, pair_b),
        jnp.where(in16, jnp.where(esc16, 128 + (h >> 2), pair_b),
                  128 + (h >> 2)))
    nr_nxt = jnp.where(
        in4, jnp.where(quad, idx + 3, idx + 2),
        jnp.where(in16 & ~esc16, idx + 2, idx + 1))

    nxt = jnp.where(runb, run_nxt, nr_nxt)
    emit = jnp.where(runb, run_emit, nr_emit)
    # the walk only runs for i < n
    nxt = jnp.where(idx < n, nxt, npad)
    visited = _walk_visited(jnp.minimum(nxt, npad), 1)
    live = visited & (idx < n) & (idx >= 1)
    vals, cnt = _compact(live, emit, jnp.int32(0), n + 8)
    first = h[:, 0][:, None]
    out = jnp.concatenate([first, vals[:, : n + 7]], axis=1)
    return out, cnt + 1


# ---------------------------------------------------------------------------
# E16: Y LL2 run/delta compression (ops/ll2.y_highres_compression,
# encoder/compress_pixel.c:471-876): mode-select stats in closed form
# per equal-pair run, one mode-parametrized walk, and the squeeze pass
# as a second walk over the emitted buffer.

YH_N = 16384


@functools.partial(jax.jit, static_argnames=("q_gt_low5",))
def y_highres_device(h, ch_res, q_gt_low5: bool):
    """(B, 16384+8257) int32 h (tree1 + heap tail), (B, 16384) ch_res.
    Returns (out, n_out, res_low, hr_word, n_hw, hr_mem, n_hm)."""
    b, npad = h.shape
    n = YH_N
    cap = npad - 1
    idx = jax.lax.broadcasted_iota(jnp.int32, (npad,), 0)
    hm1 = _flat_shift_r(h, 1, 0)
    h1 = _flat_shift_l(h, 1, 0)
    h2 = _flat_shift_l(h, 2, 0)
    scan = h - hm1
    count = h1 - h
    eq = (h1 == h) & (idx + 1 < cap)     # pair exists at k=idx+1
    nf = jax.lax.cummin(
        jnp.where(~eq, idx, 1 << 20)[:, ::-1], axis=1)[:, ::-1]
    E = jnp.take_along_axis(
        jnp.concatenate([nf, jnp.full((b, 1), 1 << 20, jnp.int32)],
                        axis=1),
        jnp.broadcast_to(jnp.minimum(idx + 1, npad - 1), (b, npad)),
        axis=1) - (idx + 1)
    E = jnp.clip(E, 0, 1 << 19)

    # ---- mode select (closed form per maximal pair-run) ----
    # pair positions k (h[k]==h[k-1]) = eq shifted: pr[k] = eq[k-1]
    pr = _flat_shift_r(eq, 1, False)
    run_start = pr & ~_flat_shift_r(pr, 1, False)
    run_end = pr & ~_flat_shift_l(pr, 1, False)
    sidx = jax.lax.cummax(jnp.where(run_start, idx, -1), axis=1)
    P = jnp.where(run_end, idx - sidx + 1, 0)
    s0 = jnp.where(run_end, sidx, 1 << 20)
    started = s0 < n        # the outer loop only reaches starts < 16384
    full16 = P // 16
    centr = jnp.clip((n - s0 + 15) // 16, 0, 1 << 19)
    Yr = jnp.where(started, jnp.minimum(full16, centr), 0)
    # the remainder is reached iff its entry is still inside the outer
    # bound; runs crossing n push the walk past n so later runs have
    # started == False automatically
    rem_ok = started & (s0 + 16 * full16 < n)
    ar = Yr + jnp.where(rem_ok & ((P % 16) >= 8), 1, 0)
    Y = jnp.sum(Yr, axis=1)
    aa = jnp.sum(ar, axis=1) + Y
    res_low = jnp.where(Y > 299, 2, jnp.where(aa > 179, 1, 0))

    # ---- per-node successor + emissions for each mode ----
    def gat(off, base):
        return jnp.take_along_axis(
            h, jnp.clip(base + off, 0, npad - 1), axis=1)

    def esc_node():
        if q_gt_low5:
            e = (jnp.full_like(h, 128),
                 128 + (h >> 1),
                 128 + (h1 >> 1))
            return e, 3, idx + 2
        e = (jnp.full_like(h, 128), 128 + (h >> 1),
             jnp.zeros_like(h))
        return e, 2, idx + 1

    (esc_e, esc_len, esc_nxt) = esc_node()
    run0 = (scan == 0) & (count == 0)
    e3_ok = (idx < n - 2) & (jnp.abs(h2 - h1) <= 32)
    e3v = h2 - h1 + 32

    def triple(s_, c_):
        cc = c_ >> 1
        return (jnp.full_like(h, 64), 64 + s_ + (cc >> 3),
                ((cc & 7) << 5) + (e3v >> 1))

    def mode0():
        a = jnp.where(E >= 1, 1, 0)
        base = idx + a + 2
        d1 = gat(0, base) - gat(-1, base)
        d2 = gat(1, base) - gat(0, base)
        code = a << 3
        c_add = jnp.where(
            d1 == 2, jnp.where(d2 == -2, 2, jnp.where(d2 == 0, 3, 1)),
            jnp.where(d1 == -2,
                      jnp.where(d2 == 2, 4, jnp.where(d2 == 0, 5, 6)),
                      jnp.where(d1 == 4, 7, 0)))
        adv = jnp.where(
            d1 == 2, jnp.where((d2 == -2) | (d2 == 0), 2, 1),
            jnp.where(d1 == -2, jnp.where((d2 == 2) | (d2 == 0), 2, 1),
                      jnp.where(d1 == 4, 1, 0)))
        run_e = code + c_add
        run_nxt = base + adv
        in68 = (jnp.abs(scan) <= 6) & (jnp.abs(count) <= 8)
        s_ = scan + 6
        c_ = count + 8
        edge = (s_ == 12) | (c_ == 16)
        s2 = s_ + 26
        c2 = c_ + 8
        esc_in = (s2 == 64) | (c2 == 32) | (e3v == 64)
        tr = triple(s2, c2)
        plain = jnp.where(s_ < 8, 32 + (s_ << 2) + (c_ >> 1),
                          jnp.where(s_ == 8, 16 + (c_ >> 1),
                                    24 + (c_ >> 1)))
        in3216 = (jnp.abs(scan) <= 32) & (jnp.abs(count) <= 16) & e3_ok
        s3 = scan + 32
        c3 = count + 16
        esc_in3 = (s3 == 64) | (c3 == 32) | (e3v == 64)
        tr3 = triple(s3, c3)
        # compose
        e0 = jnp.where(run0, run_e,
                       jnp.where(in68,
                                 jnp.where(edge,
                                           jnp.where(e3_ok & ~esc_in,
                                                     tr[0], esc_e[0]),
                                           plain),
                                 jnp.where(in3216 & ~esc_in3, tr3[0],
                                           esc_e[0])))
        e1 = jnp.where(in68 & edge & e3_ok & ~esc_in & ~run0, tr[1],
                       jnp.where(~run0 & ~in68 & in3216 & ~esc_in3,
                                 tr3[1], esc_e[1]))
        e2 = jnp.where(in68 & edge & e3_ok & ~esc_in & ~run0, tr[2],
                       jnp.where(~run0 & ~in68 & in3216 & ~esc_in3,
                                 tr3[2], esc_e[2]))
        ln = jnp.where(run0, 1,
                       jnp.where(in68,
                                 jnp.where(edge,
                                           jnp.where(e3_ok & ~esc_in, 3,
                                                     esc_len), 1),
                                 jnp.where(in3216 & ~esc_in3, 3,
                                           esc_len)))
        nxt = jnp.where(run0, run_nxt,
                        jnp.where(in68,
                                  jnp.where(edge,
                                            jnp.where(e3_ok & ~esc_in,
                                                      idx + 3, esc_nxt),
                                            idx + 2),
                                  jnp.where(in3216 & ~esc_in3, idx + 3,
                                            esc_nxt)))
        isesc = jnp.where(run0, False,
                          jnp.where(in68,
                                    edge & ~(e3_ok & ~esc_in),
                                    ~(in3216 & ~esc_in3)))
        return e0, e1, e2, ln, nxt, isesc

    def mode1():
        a = jnp.minimum(E, 7)
        base = idx + a + 2
        d1 = gat(0, base) - gat(-1, base)
        code = a << 2
        c_add = jnp.where(d1 == 2, 1,
                          jnp.where(d1 == -2, 2,
                                    jnp.where(d1 == 0, 3, 0)))
        adv = jnp.where((d1 == 2) | (d1 == -2) | (d1 == 0), 1, 0)
        run_e = code + c_add
        run_nxt = base + adv
        in48 = (jnp.abs(scan) <= 4) & (jnp.abs(count) <= 8)
        s_ = scan + 4
        c_ = count + 8
        edge = (s_ == 8) | (c_ == 16)
        s2 = s_ + 28
        c2 = c_ + 8
        esc_in = (s2 == 64) | (c2 == 32) | (e3v == 64)
        tr = triple(s2, c2)
        plain = 32 + (s_ << 2) + (c_ >> 1)
        in3216 = (jnp.abs(scan) <= 32) & (jnp.abs(count) <= 16) & e3_ok
        s3 = scan + 32
        c3 = count + 16
        esc_in3 = (s3 == 64) | (c3 == 32) | (e3v == 64)
        tr3 = triple(s3, c3)
        e0 = jnp.where(run0, run_e,
                       jnp.where(in48,
                                 jnp.where(edge,
                                           jnp.where(e3_ok & ~esc_in,
                                                     tr[0], esc_e[0]),
                                           plain),
                                 jnp.where(in3216 & ~esc_in3, tr3[0],
                                           esc_e[0])))
        e1 = jnp.where(in48 & edge & e3_ok & ~esc_in & ~run0, tr[1],
                       jnp.where(~run0 & ~in48 & in3216 & ~esc_in3,
                                 tr3[1], esc_e[1]))
        e2 = jnp.where(in48 & edge & e3_ok & ~esc_in & ~run0, tr[2],
                       jnp.where(~run0 & ~in48 & in3216 & ~esc_in3,
                                 tr3[2], esc_e[2]))
        ln = jnp.where(run0, 1,
                       jnp.where(in48,
                                 jnp.where(edge,
                                           jnp.where(e3_ok & ~esc_in, 3,
                                                     esc_len), 1),
                                 jnp.where(in3216 & ~esc_in3, 3,
                                           esc_len)))
        nxt = jnp.where(run0, run_nxt,
                        jnp.where(in48,
                                  jnp.where(edge,
                                            jnp.where(e3_ok & ~esc_in,
                                                      idx + 3, esc_nxt),
                                            idx + 2),
                                  jnp.where(in3216 & ~esc_in3, idx + 3,
                                            esc_nxt)))
        isesc = jnp.where(run0, False,
                          jnp.where(in48,
                                    edge & ~(e3_ok & ~esc_in),
                                    ~(in3216 & ~esc_in3)))
        return e0, e1, e2, ln, nxt, isesc

    def mode2():
        a = jnp.minimum(E, 63)
        run_e = a
        run_nxt = idx + a + 2
        in3216 = (jnp.abs(scan) <= 32) & (jnp.abs(count) <= 16) & e3_ok
        s3 = scan + 32
        c3 = count + 16
        esc_in3 = (s3 == 64) | (c3 == 32) | (e3v == 64)
        tr3 = triple(s3, c3)
        e0 = jnp.where(run0, run_e,
                       jnp.where(in3216 & ~esc_in3, tr3[0], esc_e[0]))
        e1 = jnp.where(~run0 & in3216 & ~esc_in3, tr3[1], esc_e[1])
        e2 = jnp.where(~run0 & in3216 & ~esc_in3, tr3[2], esc_e[2])
        ln = jnp.where(run0, 1,
                       jnp.where(in3216 & ~esc_in3, 3, esc_len))
        nxt = jnp.where(run0, run_nxt,
                        jnp.where(in3216 & ~esc_in3, idx + 3, esc_nxt))
        isesc = ~run0 & ~(in3216 & ~esc_in3)
        return e0, e1, e2, ln, nxt, isesc

    m0 = mode0()
    m1 = mode1()
    m2 = mode2()
    rl = res_low[:, None]

    def sel(k):
        return jnp.where(rl == 0, m0[k],
                         jnp.where(rl == 1, m1[k], m2[k]))

    e0, e1, e2, ln, nxt = (sel(k) for k in range(5))
    isesc = jnp.where(rl == 0, m0[5], jnp.where(rl == 1, m1[5], m2[5]))

    nxt = jnp.where(idx < n, nxt, npad)
    visited = _walk_visited(jnp.minimum(nxt, npad), 1)
    live = visited & (idx < n) & (idx >= 1)

    # hr_word / hr_mem from visited escapes (in index order)
    esc_live = live & isesc
    hr_word, n_hw = _compact(
        esc_live, jnp.concatenate(
            [ch_res, jnp.zeros((b, npad - n), jnp.int32)], axis=1),
        jnp.int32(0), YH_N)
    hr_mem, n_hm = _compact(
        esc_live, jnp.broadcast_to(idx, (b, npad)), jnp.int32(0), YH_N)
    if not q_gt_low5:
        n_hw = jnp.zeros_like(n_hw)
        n_hm = jnp.zeros_like(n_hm)

    # scatter emissions into the ch buffer (head byte h[0] at 0)
    CH = 1 << 16
    lens = jnp.where(live, ln, 0)
    off = 1 + jnp.cumsum(lens, axis=1) - lens
    rowO = (jnp.arange(b, dtype=jnp.int32) * CH)[:, None]
    seq = jnp.arange(b * npad, dtype=jnp.int32).reshape(b, npad)
    ch = jnp.zeros(b * CH, jnp.int32)
    for k, ek in enumerate((e0, e1, e2)):
        mk = live & (ln > k)
        tgt = jnp.where(mk, off + k + rowO, b * CH + seq).reshape(-1)
        ch = ch.at[tgt].set(ek.reshape(-1), mode="drop",
                            unique_indices=True)
    ch = ch.reshape(b, CH)
    ch = ch.at[:, 0].set(h[:, 0])
    n_ch = 1 + jnp.sum(lens, axis=1)

    # ---- squeeze walk over the ch buffer ----
    cidx = jax.lax.broadcasted_iota(jnp.int32, (CH,), 0)
    c1 = _flat_shift_l(ch, 1, 0)
    c2 = _flat_shift_l(ch, 2, 0)
    is64 = ch == 64
    is128 = ch == 128
    if q_gt_low5:
        sq_nxt = jnp.where(is64 | is128, cidx + 3, cidx + 1)
        sq_e0 = jnp.where(is64, c1, jnp.where(is128, c2, ch))
        sq_e1 = c2
        sq_len = jnp.where(is64, 2, 1)
    else:
        sq_nxt = jnp.where(is64, cidx + 3,
                           jnp.where(is128, cidx + 2, cidx + 1))
        sq_e0 = jnp.where(is64 | is128, c1, ch)
        sq_e1 = c2
        sq_len = jnp.where(is64, 2, 1)
    bound = (n_ch - 1)[:, None]
    sq_nxt = jnp.where(cidx < bound, sq_nxt, CH)
    sq_vis = _walk_visited(jnp.minimum(sq_nxt, CH), 1)
    sq_live = sq_vis & (cidx >= 1) & (cidx < bound)
    # the trailing byte: emitted iff the walk lands exactly on n_ch-1
    tail_hit = jnp.take_along_axis(sq_vis, jnp.maximum(bound, 0),
                                   axis=1)[:, 0] & (n_ch > 1)[..., ]
    lens2 = jnp.where(sq_live, sq_len, 0)
    off2 = 1 + jnp.cumsum(lens2, axis=1) - lens2
    out = jnp.zeros(b * CH, jnp.int32)
    seq2 = jnp.arange(b * CH, dtype=jnp.int32).reshape(b, CH)
    rowO2 = (jnp.arange(b, dtype=jnp.int32) * CH)[:, None]
    for k, ek in enumerate((sq_e0, sq_e1)):
        mk = sq_live & (sq_len > k)
        tgt = jnp.where(mk, off2 + k + rowO2, b * CH + seq2).reshape(-1)
        out = out.at[tgt].set(ek.reshape(-1), mode="drop",
                              unique_indices=True)
    out = out.reshape(b, CH)
    out = out.at[:, 0].set(ch[:, 0])
    n_out = 1 + jnp.sum(lens2, axis=1)
    # append ch[n_ch-1] when the walk hit it
    lastv = jnp.take_along_axis(ch, jnp.maximum(bound, 0), axis=1)[:, 0]
    out = jnp.where(
        (jnp.broadcast_to(cidx, (b, CH)) == n_out[:, None]) & tail_hit[:, None],
        lastv[:, None], out)
    n_out = n_out + tail_hit.astype(jnp.int32)
    return out, n_out, res_low, hr_word, n_hw, hr_mem, n_hm


# ---------------------------------------------------------------------------
# E16 head: LL2 byte-coding (ops/ll2.ll2_code_y,
# encoder/nhw_encoder.c:636-743): the 4-run odd marking pre-pass is a
# per-row skip walk; the odd-pattern nudges chain within rows only
# through a parity-suppressing +1 (run parity) and into the next row
# (a 128-step scan); emissions reuse the last-non-escape fill.


def _ll2y_row(gt_low3: bool):
    def row(pend, xs):
        # rows are 131 wide: the flat reads at j=126/127 cross into
        # plane columns 128-129 (the band area)
        (I_r, I_r1, I_r2, I_r3, r_first, r_le126, r_in124) = xs
        b = I_r.shape[0]
        cur = I_r + pend                      # nudges from the row above
        jc = jax.lax.broadcasted_iota(jnp.int32, (131,), 0)
        odd = (cur & 1) == 1
        marked = gt_low3 & (cur > 10000)
        o1 = (_flat_shift_l(cur) & 1) == 1
        o2 = (_flat_shift_l(cur, 2) & 1) == 1
        i2v = _flat_shift_l(cur, 2)
        # within-row 2a fire (the only within-row writer)
        out2a = (~marked) & odd & (jc > 0) & o1 & (jc < 126) & o2
        F2a = out2a & (jnp.abs(cur - i2v) > 1) & gt_low3
        fire = _run_parity_fire(F2a)
        nudged = _flat_shift_r(fire, 1, False)
        v = cur + nudged
        odd_v = (v & 1) == 1
        # cross-row nudges (targets row r+1 col j)
        n0 = I_r1
        n1 = _flat_shift_l(I_r1)
        n2 = _flat_shift_l(I_r1, 2)
        m2 = I_r2
        m3 = I_r3
        o2a_tail = (jc < 126) & o2
        b2b = ((~marked) & odd_v & (jc > 0) & o1 & ~o2a_tail & r_le126
               & ((n0 & 1) == 1) & ((n1 & 1) == 1) & ((n2 & 1) == 0)
               & (n0 < 10000) & gt_low3)
        b3 = ((~marked) & odd_v & ~((jc > 0) & o1) & r_in124
              & ((n0 & 1) == 1) & ((n1 & 1) == 1) & ((m2 & 1) == 1)
              & ((m3 & 1) == 0) & (n0 < 10000) & gt_low3)
        pend_next = (b2b | b3).astype(jnp.int32)
        pend_next = pend_next.at[:, 128:].set(0)
        # emission value: unmark on the nudged value
        is24 = gt_low3 & (v > 20000)
        vem = jnp.where(is24, v - 24000,
                        jnp.where(gt_low3 & (v > 10000), v - 16000, v))
        return pend_next, (vem[:, :128], is24[:, :128])
    return row


@functools.partial(jax.jit, static_argnames=("gt_low3",))
def ll2_code_y_device(plane, gt_low3: bool):
    """ll2_code_y on (B,512,512) int16 planes.  Returns (plane',
    tree1(B,16384) u8, ch_res(B,16384) u8, exw(B,16384,3), n_exw,
    res4(B, 16512), n_res4)."""
    b = plane.shape[0]
    I = jnp.asarray(plane).astype(jnp.int32)
    ll = I[:, :128, :128]

    if gt_low3:
        # 4-run odd marking: per-row skip walk (j < 125)
        o = (ll & 1) == 1
        o1 = _zpad(o[..., 1:], [(-1, (0, 1))], False)
        o2 = _zpad(o[..., 2:], [(-1, (0, 2))], False)
        o3 = _zpad(o[..., 3:], [(-1, (0, 3))], False)
        l3 = _zpad(ll[..., 3:], [(-1, (0, 3))], 0)
        jc = jax.lax.broadcasted_iota(jnp.int32, (128, 128), 1)
        match = (jc < 125) & o & o1 & o2 & o3 \
            & (jnp.abs(ll - l3) > 1)
        k = jnp.where(match, 4, 1)
        before = _skip_walk_states(k)
        fired = match & (before == 0)
        add = (fired.astype(jnp.int32) * 24000
               + _zpad(fired[..., :-1], [(-1, (1, 0))],
                       False).astype(jnp.int32) * 16000
               + _zpad(fired[..., :-2], [(-1, (2, 0))],
                       False).astype(jnp.int32) * 16000
               + _zpad(fired[..., :-3], [(-1, (3, 0))],
                       False).astype(jnp.int32) * 16000)
        ll = ll + add

    # nudge scan over rows (131-wide: flat reads cross into cols
    # 128-130 of the plane, which the pre-pass never marks)
    llw = I.at[:, :128, :128].set(ll)[:, :, :131]
    llp = jnp.concatenate(
        [llw[:, :131], jnp.zeros((b, 3, 131), jnp.int32)], axis=1)
    rows = jnp.arange(128)
    xs = (jnp.swapaxes(llw[:, :128], 0, 1),
          jnp.swapaxes(llp[:, 1:129], 0, 1),
          jnp.swapaxes(llp[:, 2:130], 0, 1),
          jnp.swapaxes(llp[:, 3:131], 0, 1),
          rows == 0, rows <= 126, (rows >= 1) & (rows <= 124))
    pend0 = jnp.zeros((b, 131), jnp.int32)
    _, (vem, is24) = jax.lax.scan(_ll2y_row(gt_low3), pend0, xs)
    vem = jnp.swapaxes(vem, 0, 1).reshape(b, 16384)
    is24 = jnp.swapaxes(is24, 0, 1).reshape(b, 16384)

    # emissions (escape fill like the UV coder)
    idx = jax.lax.broadcasted_iota(jnp.int32, (16384,), 0)
    esc_p = (vem > 255) & (idx > 0)
    esc_n = (vem < 0) & (idx > 0)
    esc = esc_p | esc_n
    clip = jnp.clip(vem, 0, 255)
    src = jax.lax.cummax(jnp.where(~esc, idx, -1), axis=1)
    prev_src = jnp.concatenate(
        [jnp.zeros((b, 1), jnp.int32), src[:, :-1]], axis=1)
    fill_t = jnp.take_along_axis(clip & 254, jnp.maximum(prev_src, 0),
                                 axis=1)
    tree1 = jnp.where(esc, fill_t, clip & 254).astype(jnp.uint8)
    ch_res = jnp.where(esc, fill_t, clip).astype(jnp.uint8)
    rr = jnp.broadcast_to(idx >> 7, esc.shape)
    jj = idx & 127
    ev = jnp.stack([rr, jnp.where(esc_p, jj + 128, jj),
                    jnp.where(esc_p, jnp.minimum(vem - 255, 255),
                              -jnp.maximum(vem, -255))], axis=-1)
    rank = jnp.cumsum(esc.astype(jnp.int32), axis=1) - esc
    rowO = (jnp.arange(b, dtype=jnp.int32) * 16384)[:, None]
    seq = jnp.arange(b * 16384, dtype=jnp.int32).reshape(b, 16384)
    tgt = jnp.where(esc, rank + rowO, b * 16384 + seq).reshape(-1)
    exw = jnp.zeros((b * 16384, 3), jnp.int32)
    exw = exw.at[tgt].set(ev.reshape(-1, 3), mode="drop",
                          unique_indices=True)
    n_exw = jnp.sum(esc.astype(jnp.int32), axis=1)

    # res4: per row, the 24000-mark columns (j+1 each, last +128), or a
    # single 128 for rows without any
    m24 = is24.reshape(b, 128, 128)
    jr = jax.lax.broadcasted_iota(jnp.int32, (128, 128), 1)
    last = m24 & ~(jax.lax.cummax(
        jnp.where(m24, jr, -1)[..., ::-1], axis=2)[..., ::-1] > jr)
    val = (jr + 1) + jnp.where(last, 128, 0)
    any24 = jnp.any(m24, axis=2)
    # emission grid (B, 128, 129): per-j marks then the placeholder
    grid_m = jnp.concatenate([m24, (~any24)[..., None]], axis=2)
    grid_v = jnp.concatenate(
        [val, jnp.full(any24.shape + (1,), 128, jnp.int32)], axis=2)
    res4, n_res4 = _compact(grid_m.reshape(b, -1),
                            grid_v.reshape(b, -1), jnp.int32(0),
                            128 * 129)
    out = I.at[:, :128, :128].set(0)
    return (out.astype(jnp.int16), tree1, ch_res,
            exw.reshape(b, 16384, 3), n_exw, res4, n_res4)


# ---------------------------------------------------------------------------
# E11 tail: paired-code promotion to sentinels 10100-12900
# (models/encoder._pair_promotion, encoder/nhw_encoder.c:970-1074).
#
# Dead-branch analysis (the elif chains consume matched-outer-failed-
# inner cases): v==7 is consumed by 4<v<8 and v==-7/-6 by -8<v<-4, so
# the 10204/10300 promotions and the lower half's a-N/a+D vertical
# cases NEVER fire — the live branches are the 12700/12900 triples and
# the v==+-8 rewrites.  That leaves only the within-row left chain
# (value-mediated: every write lands a sentinel that fails all later
# range tests), resolved as a Jacobi fixpoint on the decision plane;
# both blocks are row-independent.


def _pp_decide(vl, v, vr, band: bool):
    """Decision codes: 0 none, 1=12700 triple, 2=12900 triple,
    6=own 10, 7=own -9, 8=9/9 pair (band), 9=-9/-9 pair (band)."""
    outer1 = (v > 4) & (v < 8)
    inner1 = (vl > 3) & (vl <= 7) & (vr > 3) & (vr <= 7)
    outer2 = (v > -8) & (v < -4)
    inner2 = (vl > -8) & (vl <= -4) & (vr > -8) & (vr <= -4)
    c6a = ((vl & 65534) == 6) | ((vr & 65534) == 6)
    c7a = (((-vl) & 65534) == 6) | (((-vr) & 65534) == 6)
    if band:
        d8 = jnp.where(c6a, 6, jnp.where(vr == 8, 8, 0))
        d9 = jnp.where(c7a, 7, jnp.where(vr == -8, 9, 0))
    else:
        d8 = jnp.where(c6a, 6, 0)
        d9 = jnp.where(c7a, 7, 0)
    return jnp.where(outer1, jnp.where(inner1, 1, 0),
                     jnp.where(outer2, jnp.where(inner2, 2, 0),
                               jnp.where(v == 8, d8,
                                         jnp.where(v == -8, d9, 0))))


def _pp_vvisit(I, dec_left):
    """Own value at visit time: the left neighbour's a+1 write."""
    return jnp.where((dec_left == 1) | (dec_left == 2), 10100,
                     jnp.where(dec_left == 8, 9,
                               jnp.where(dec_left == 9, -9, I)))


def _pp_own(vvis, dec):
    """Value after the visit's own write."""
    return jnp.where(dec == 1, 12700,
                     jnp.where(dec == 2, 12900,
                               jnp.where(dec == 6, 10,
                                         jnp.where((dec == 7) | (dec == 9),
                                                   -9,
                                                   jnp.where(dec == 8, 9,
                                                             vvis)))))


def _pp_block(I, reg, band: bool):
    vr = _flat_shift_l(I)                    # right reads: row input

    def step(dec):
        dl = _flat_shift_r(dec)
        vvis = _pp_vvisit(I, dl)
        dll = _flat_shift_r(dl)
        vl = _pp_own(_pp_vvisit(_flat_shift_r(I), dll), dl)
        return jnp.where(reg, _pp_decide(vl, vvis, vr, band), 0)

    def body(state):
        dec, _ = state
        d2 = step(dec)
        return d2, jnp.any(d2 != dec)

    d0 = step(jnp.zeros_like(I))
    dec, _ = jax.lax.while_loop(lambda s: s[1], body,
                                (d0, jnp.bool_(True)))
    out = _pp_own(_pp_vvisit(I, _flat_shift_r(dec)), dec)
    # the a-1 10100 writes from cases 1/2 (arrive after the visit)
    from_right = _flat_shift_l(dec)
    return jnp.where((from_right == 1) | (from_right == 2), 10100, out)


@jax.jit
def pair_promotion_device(plane):
    """_pair_promotion on (B,512,512) int16 planes, bit-exact."""
    I0 = jnp.asarray(plane).astype(jnp.int32)
    col = _col_iota()
    row = _row_iota()
    reg1 = (row >= 1) & (row < 255) & (col >= 257) & (col < 511)
    I1 = _pp_block(I0, reg1, True)
    reg2 = (row >= 257) & (row < 511) & (col >= 1) & (col < 255)
    I2 = _pp_block(I1, reg2, False)
    return I2.astype(jnp.int16)


@jax.jit
def mid_q_band_cleanup_device(plane):
    """models/encoder._mid_q_band_cleanup (LOW5<q<NORM): snap small
    lower-half coefficients to +-7 — pure elementwise."""
    I = jnp.asarray(plane).astype(jnp.int32)
    lower = I[:, 256:, :]
    left = lower[:, :, :256]
    av = jnp.abs(left)
    m = (av >= 8) & (av < 9)
    left2 = jnp.where(m, jnp.where(left > 0, 7, -7), left)
    right = lower[:, :, 256:]
    av = jnp.abs(right)
    m = (av >= 8) & (av <= 14)
    right2 = jnp.where(m, jnp.where(right > 0, 7, -7), right)
    out = I.at[:, 256:, :256].set(left2).at[:, 256:, 256:].set(right2)
    return out.astype(jnp.int16)


@functools.partial(jax.jit, static_argnames=("x1",))
def low_q_ll1_cleanup_device(plane, x1: int):
    """models/encoder._low_q_ll1_cleanup (q<=LOW9): isolated-coefficient
    zeroing in rows 128..255 cols 0..255.  Left reads are post-write,
    right reads initial — a per-row Jacobi (zeroing the left neighbour
    widens the isolation test rightward)."""
    I = jnp.asarray(plane).astype(jnp.int32)
    ratio = 8
    reg = I[:, 128:256, :]          # full 512 cols for the flat shifts
    Ireg = reg
    IL = _flat_shift_l(Ireg)        # right neighbour, initial
    col = jax.lax.broadcasted_iota(jnp.int32, (N,), 0)
    inreg = col < 256

    def decide(left_cur, v):
        av = jnp.abs(v)
        cand = inreg & (av >= ratio) & (av < x1)
        lsm = jnp.abs(left_cur) < ratio
        rsm = jnp.abs(IL) < ratio
        z = cand & ((lsm & rsm) | ((av == ratio) & (lsm | rsm)))
        return jnp.where(z, 0, v)

    def body(state):
        F, _ = state
        # left neighbour: flat previous element; col 0 reads the
        # previous row's col 511 (outside the region -> initial)
        left = _flat_shift_r(F)
        left = left.at[:, :, 0].set(
            jnp.concatenate([I[:, 127:128, 511],
                             F[:, :-1, 511]], axis=1))
        F2 = decide(left, Ireg)
        return F2, jnp.any(F2 != F)

    F0, _ = body((Ireg, True))
    F, _ = jax.lax.while_loop(lambda s: s[1], body, (F0, jnp.bool_(True)))
    return plane.astype(jnp.int32).at[:, 128:256, :].set(
        F).astype(jnp.int16)


def _lolo_phase(vin, left, right_i, r3ok, ratio, tlo, thi, x5,
                snap16, xlo2):
    """One visit of the q<LOW6 dead-zoning: phase-1 (r3 guard or pair
    zeroing) then the phase-2 re-read."""
    av = jnp.abs(vin)
    cand1 = (av >= ratio) & (av < thi)
    z_r3 = cand1 & r3ok
    pairL = cand1 & ~z_r3 & (jnp.abs(vin + left) < x5) \
        & (jnp.abs(right_i) < x5)
    pairR = cand1 & ~z_r3 & ~pairL & (jnp.abs(vin + right_i) < x5) \
        & (jnp.abs(left) < x5)
    v1 = jnp.where(z_r3 | pairL | pairR, 0, vin)
    av2 = jnp.abs(v1)
    cand2 = (av2 >= ratio) & (av2 < tlo)
    iso = cand2 & (jnp.abs(left) < ratio) & (jnp.abs(right_i) < ratio)
    lo2 = cand2 & ~iso & (av2 < tlo - xlo2) if xlo2 is not None \
        else jnp.zeros_like(iso)
    hit = iso | lo2
    v2 = jnp.where(hit,
                   jnp.where(snap16,
                             jnp.where(v1 >= 16, 7,
                                       jnp.where(v1 <= -16, -7, 0)),
                             0), v1)
    return v2, pairL, pairR


def lowest_q_band_cleanup_device(plane, r3_ext, quality: int,
                                 xs: tuple):
    """models/encoder._lowest_q_band_cleanup (q<LOW6).  Loop A (rows
    0..255 cols 256..511) is a row-local Jacobi with static boundary
    reads; loops B+C are ONE left-to-right row walk over cols 0..510
    of rows 256..511 (parameter switch at col 256) whose col-0 left
    read chains flat into the previous row's col 511 — a single Jacobi
    over the half-plane.  r3_ext: (B, 65536+256) int16."""
    from nhwcodec_tpu import tables as T

    x1, x2, x3, x4, x5 = xs
    gt10 = quality > T.LOW10
    I0 = jnp.asarray(plane).astype(jnp.int32)
    r3 = jnp.asarray(r3_ext).astype(jnp.int32)
    b = I0.shape[0]

    def gather_r3(idx, thr):
        return jnp.abs(jnp.take_along_axis(
            r3, jnp.broadcast_to(idx.reshape(-1), (b, idx.size)),
            axis=1).reshape((b,) + idx.shape)) < thr

    row = jax.lax.broadcasted_iota(jnp.int32, (256, 256), 0)
    col = jax.lax.broadcasted_iota(jnp.int32, (256, 256), 1)

    # ---- loop A: rows 0..255, cols 256..511 (col 511 visited) ----
    IA = I0[:, :256, 256:]
    r3A = gather_r3(((row * 256 + col) >> 1) + 128, x4)
    leftB = I0[:, :256, 255]                     # static left boundary
    # right of col 511 = flat next-row col 0 (LL region, static)
    rightB = jnp.concatenate([I0[:, 1:256, 0], I0[:, 256:257, 0]],
                             axis=1)
    IR_A = _flat_shift_l(IA).at[:, :, 255].set(rightB)

    def bodyA(state):
        F, wr, _ = state
        vin = jnp.where(_flat_shift_r(wr, 1, False), 0, IA)
        left = _flat_shift_r(F).at[:, :, 0].set(leftB)
        v2, pl, pr = _lolo_phase(vin, left, IR_A, r3A, 8, x3, x3 + 2,
                                 x5, False, None)
        return v2, pr, jnp.any((v2 != F) | (pr != wr))

    zA = jnp.zeros(IA.shape, bool)
    FA, wrA, _ = bodyA((IA, zA, True))
    FA, wrA, _ = jax.lax.while_loop(lambda st: st[2], bodyA,
                                    (FA, wrA, jnp.bool_(True)))
    # re-derive the left/right write masks against the fixpoint
    vinA = jnp.where(_flat_shift_r(wrA, 1, False), 0, IA)
    _, plA, prA = _lolo_phase(vinA,
                              _flat_shift_r(FA).at[:, :, 0].set(leftB),
                              IR_A, r3A, 8, x3, x3 + 2, x5, False, None)
    FA = jnp.where(_flat_shift_l(plA, 1, False), 0, FA)
    FA = jnp.where(_flat_shift_r(prA, 1, False), 0, FA)
    out = I0.at[:, :256, 256:].set(FA)
    # boundary writes that leave the region: pairL at abs col 256
    # zeroes col 255, and pairR at abs col 511 zeroes the flat next
    # row's col 0 (rows 1..256 — row 256 feeds the B+C input)
    out = out.at[:, :256, 255].set(
        jnp.where(plA[:, :, 0], 0, out[:, :256, 255]))
    out = out.at[:, 1:257, 0].set(
        jnp.where(prA[:, :, 255], 0, out[:, 1:257, 0]))

    # ---- loops B+C combined: rows 256..511, cols 0..511 ----
    IH = out[:, 256:, :]                          # (B,256,512)
    colH = jax.lax.broadcasted_iota(jnp.int32, (512,), 0)
    isB = colH < 256
    isC = (colH >= 256) & (colH < 511)
    live = isB | isC
    # per-column parameters
    ratioH = 8
    tlo = jnp.where(isB, x1, x2)
    thi = jnp.where(isB, x1 + 2, x2 + 1)
    xlo2 = jnp.where(isB, 4, 5)
    snapH = jnp.where(isB, False, jnp.bool_(gt10))
    idxB = ((row * 256 + col) >> 1) + (SZ >> 1)
    idxC = ((row * 256 + col) >> 1) + (SZ >> 1) + 128
    r3okB = gather_r3(idxB, x4)
    r3okC = gather_r3(idxC, x4 + 1)
    r3H = jnp.concatenate([r3okB, r3okC], axis=2)
    IR_H = _flat_shift_l(IH)       # right reads: initial, flat in-row

    def visitH(vin, left):
        av = jnp.abs(vin)
        cand1 = live & (av >= ratioH) & (av < thi)
        z_r3 = cand1 & r3H
        pairL = cand1 & ~z_r3 & (jnp.abs(vin + left) < x5) \
            & (jnp.abs(IR_H) < x5)
        pairR = cand1 & ~z_r3 & ~pairL & (jnp.abs(vin + IR_H) < x5) \
            & (jnp.abs(left) < x5)
        v1 = jnp.where(z_r3 | pairL | pairR, 0, vin)
        av2 = jnp.abs(v1)
        cand2 = live & (av2 >= ratioH) & (av2 < tlo)
        iso = cand2 & (jnp.abs(left) < ratioH) & (jnp.abs(IR_H) < ratioH)
        lo2 = cand2 & ~iso & (av2 < tlo - xlo2)
        hit = iso | lo2
        snap = jnp.where(v1 >= 16, 7, jnp.where(v1 <= -16, -7, 0))
        v2 = jnp.where(hit, jnp.where(snapH, snap, 0), v1)
        return v2, pairL, pairR

    def leftH(F):
        # flat left: col 0 chains into the previous row's col 511; the
        # first row's col 0 reads loop A's final row-255 col 511
        lf = _flat_shift_r(F)
        prev511 = jnp.concatenate([FA[:, 255:256, 255],
                                   F[:, :-1, 511]], axis=1)
        return lf.at[:, :, 0].set(prev511)

    def bodyH(state):
        F, wr, _ = state
        vin = jnp.where(_flat_shift_r(wr, 1, False), 0, IH)
        v2, pl, pr = visitH(vin, leftH(F))
        return v2, pr, jnp.any((v2 != F) | (pr != wr))

    zH = jnp.zeros(IH.shape, bool)
    FH, wrH, _ = bodyH((IH, zH, True))
    FH, wrH, _ = jax.lax.while_loop(lambda st: st[2], bodyH,
                                    (FH, wrH, jnp.bool_(True)))
    vinH = jnp.where(_flat_shift_r(wrH, 1, False), 0, IH)
    _, plH, prH = visitH(vinH, leftH(FH))
    FH = jnp.where(_flat_shift_l(plH, 1, False), 0, FH)
    FH = jnp.where(_flat_shift_r(prH, 1, False), 0, FH)
    # pairL at col 0 zeroes the flat previous row's col 511 (row 255
    # of the A output for the first row, in-region above)
    FH = FH.at[:, :255, 511].set(
        jnp.where(plH[:, 1:, 0], 0, FH[:, :255, 511]))
    out = out.at[:, 256:, :].set(FH)
    out = out.at[:, 255, 511].set(
        jnp.where(plH[:, 0, 0], 0, out[:, 255, 511]))
    return out.astype(jnp.int16)


def _uvs_row(thr3: int, thr4: int, variant: int):
    """One row step of _uv_ll_smooth (encoder/nhw_encoder.c:2438-2477).
    The visit at (r, j) writes (r+1, j+1), which is read ONLY by the
    next visit (r, j+1) as its own (r+1, j) value — a strict 1-step
    recurrence, resolved by a 62-step inner scan over the columns (the
    smoothing average is not idempotent, so a Jacobi fixpoint would
    diverge from the one-pass semantics)."""

    def step(row0, xs):
        row1_init, row2 = xs

        def col_body(carry, x):
            prev_fire, prev_val = carry
            (r1i, r1i1, r1i2, r0, r0s, r0s2, r2s, jc) = x
            r1v = jnp.where(prev_fire, prev_val, r1i)
            ok = jc < 62
            if variant == 1:
                fire = ok \
                    & (jnp.abs(r0s - r2s) < thr3) \
                    & (jnp.abs(r1v - r1i2) < thr3) \
                    & (jnp.abs(r1i1 - r1v) < thr4 - 1) \
                    & (jnp.abs(r0s - r1i1) < thr4)
                val = (r0s + r2s + r1v + r1i2 + 2) >> 2
            else:
                fire = ok \
                    & (jnp.abs(r0s2 - r0s) < thr3) \
                    & (jnp.abs(r0s - r0) < thr3) \
                    & (jnp.abs(r0 - r1v) < thr3) \
                    & (jnp.abs(r0s2 - r1i2) < thr3) \
                    & (jnp.abs(r2s - r1v) < thr3) \
                    & (jnp.abs(r1v - r1i1) < thr4)
                val = (r0s + r2s + r1v + r1i2 + 1) >> 2
            return (fire, val), r1v

        n = row0.shape[-1]
        r1s1 = _flat_shift_l(row1_init)
        r1s2 = _flat_shift_l(row1_init, 2)
        r0s = _flat_shift_l(row0)
        r0s2 = _flat_shift_l(row0, 2)
        r2s = _flat_shift_l(row2)
        jc = jnp.broadcast_to(
            jax.lax.broadcasted_iota(jnp.int32, (n,), 0),
            row0.shape)
        xs_cols = tuple(jnp.moveaxis(a, -1, 0) for a in
                        (row1_init, r1s1, r1s2, row0, r0s, r0s2, r2s,
                         jc))
        b = row0.shape[0]
        carry0 = (jnp.zeros((b,), bool), jnp.zeros((b,), jnp.int32))
        (last_fire, last_val), r1v_cols = jax.lax.scan(
            col_body, carry0, xs_cols)
        r1f = jnp.moveaxis(r1v_cols, 0, -1)
        # the final column beyond the scan keeps its initial value
        # (writes reach at most col 62 < n)
        return r1f, r1f

    return step


def uv_ll_smooth_device(process):
    """models/encoder._uv_ll_smooth (q<=LOW9) on (B,256,256) planes:
    two sequential passes, each a 62-row scan of 62-step column scans."""
    I = jnp.asarray(process).astype(jnp.int32)

    def run(plane, variant):
        reg = plane[:, :64, :64]
        xs = (jnp.swapaxes(reg[:, 1:63], 0, 1),
              jnp.swapaxes(reg[:, 2:64], 0, 1))
        _, ys = jax.lax.scan(_uvs_row(5, 8, variant), reg[:, 0], xs)
        return plane.at[:, 1:63, :64].set(jnp.swapaxes(ys, 0, 1))

    out = run(I, 1)
    out = run(out, 2)
    return out.astype(jnp.int16)


# ---------------------------------------------------------------------------
# E11 low-q: the very-low-q cleanup (models/encoder._very_low_q_cleanup,
# encoder/nhw_encoder.c:311-621): four passes over the LL2 quadrant.
# Non-idempotent smoothing writes force true sequential column scans
# (like uv_ll_smooth); the far-band threshold zeroings are absorbing
# and order-independent, so they collect as fire masks and apply once;
# the shared stale `carry` position threads through as a scalar.


def _vlq_p1_row(x1: int, x2: int):
    def col(cstate, x):
        fw2, wv2, fw1, wv1 = cstate
        i0, i1, i2, i3, i4, jc = x
        p0 = jnp.where(fw2, wv2, i0)
        p1 = jnp.where(fw1, wv1, i1)
        p2, p3, p4 = i2, i3, i4
        ok = jc < 124
        c1 = ok & (jnp.abs(p4 - p0) < x1) & (jnp.abs(p4 - p3) < x1) \
            & (jnp.abs(p1 - p0) < x1) & (jnp.abs(p3 - p1) < x1) \
            & (jnp.abs(p3 - p2) < x2 - 2)
        b1 = (p3 - p1 > 5) & (p2 - p3 >= 0)
        b2 = ~b1 & (p1 - p3 > 5) & (p2 - p3 <= 0)
        b3 = ~b1 & ~b2 & (p1 - p3 > 5) & (p2 - p1 >= 0)
        b4 = ~b1 & ~b2 & ~b3 & (p3 - p1 > 5) & (p2 - p1 <= 0)
        b5 = ~b1 & ~b2 & ~b3 & ~b4 & (p3 - p2 > 0) & (p2 - p1 > 0)
        b6 = ~b1 & ~b2 & ~b3 & ~b4 & ~b5 & (p1 - p2 > 0) & (p2 - p3 > 0)
        wv = jnp.where(b1 | b2, p3,
                       jnp.where(b3 | b4, p1, (p3 + p1) >> 1))
        fireW = c1 & ~(b5 | b6)
        c2 = ok & ~c1 & (jnp.abs(p4 - p0) < x2 + 1) \
            & (jnp.abs(p4 - p3) < x2 + 1) & (jnp.abs(p1 - p0) < x2 + 1) \
            & (jnp.abs(p3 - p1) < x2 + 6) & (jnp.abs(p3 - p2) < x2 + 6) \
            & (((p3 - p2 >= 0) & (p2 - p1 >= 0))
               | ((p3 - p2 <= 0) & (p2 - p1 <= 0)))
        fireAny = c1 | c2
        return (fw1, wv1, fireW, wv), (fireW, wv, fireAny)
    return col


def _vlq_row_scan(col_fn, row_arrs, b):
    """Run a per-column sequential scan over stacked row inputs."""
    xs = tuple(jnp.moveaxis(a, -1, 0) for a in row_arrs)
    z = (jnp.zeros(row_arrs[0].shape[:-1], bool),
         jnp.zeros(row_arrs[0].shape[:-1], jnp.int32),
         jnp.zeros(row_arrs[0].shape[:-1], bool),
         jnp.zeros(row_arrs[0].shape[:-1], jnp.int32))
    _, ys = jax.lax.scan(col_fn, z, xs)
    return tuple(jnp.moveaxis(y, 0, -1) for y in ys)


def _vlq_p23_step(x3: int, x4: int, variant: int):
    """Pass 2/3 row step: visit (r,j) reads rows r (settled), r+1
    (1-step write recurrence) and r+2 (initial); writes (r+1, j+1).
    Emits (fire, wrote, val) per column for the carry/zero tracking."""

    def step(row0, xs):
        row1_init, row2 = xs

        def col(cstate, x):
            pf1, pv1 = cstate          # pending write to (r+1, j)
            (r1i, r1i1, r1i2, r0, r0s, r0s2, r2s, jc) = x
            a0 = jnp.where(pf1, pv1, r1i)      # (r+1, j) at visit
            ok = jc < 126
            if variant == 2:
                outer = ok & (jnp.abs(r0s - r2s) < x3) \
                    & (jnp.abs(a0 - r1i2) < x3)
                inner = outer & (jnp.abs(r1i1 - a0) < x4 - 1) \
                    & (jnp.abs(r0s - r1i1) < x4)
                e = (r0s + r2s + a0 + r1i2 + 2) >> 2
                ew = inner & ((jnp.abs(e - a0) < 5)
                              | (jnp.abs(e - r1i2) < 5))
                fire = inner
            else:
                outer = ok & (jnp.abs(r0s2 - r0s) < x3) \
                    & (jnp.abs(r0s - r0) < x3) \
                    & (jnp.abs(r0 - a0) < x3) \
                    & (jnp.abs(r0s2 - r1i2) < x3)
                inner = outer & (jnp.abs(r2s - a0) < x3) \
                    & (jnp.abs(a0 - r1i1) < x4)
                e = (r0s + r2s + a0 + r1i2 + 1) >> 2
                ew = inner & ((jnp.abs(e - a0) < 5)
                              | (jnp.abs(e - r1i2) < 5))
                fire = inner
            return (ew, e), (a0, fire, ew, e, outer)

        n = row0.shape[-1]
        arrs = (row1_init, _flat_shift_l(row1_init),
                _flat_shift_l(row1_init, 2), row0,
                _flat_shift_l(row0), _flat_shift_l(row0, 2),
                _flat_shift_l(row2),
                jnp.broadcast_to(jax.lax.broadcasted_iota(
                    jnp.int32, (n,), 0), row0.shape))
        xs_c = tuple(jnp.moveaxis(a, -1, 0) for a in arrs)
        bshape = row0.shape[:-1]
        z = (jnp.zeros(bshape, bool), jnp.zeros(bshape, jnp.int32))
        (lf, lv), ys = jax.lax.scan(col, z, xs_c)
        a0v, fire, ew, ev, outer = (jnp.moveaxis(y, 0, -1) for y in ys)
        # final row r+1 values: each position's visit-time value, and
        # the very last pending write lands at (r+1, n-1)... writes
        # reach col <= 126+1 = 127 < n, captured by a0v of later cols
        # plus the final pending (applies to position n-1 only if
        # jc 126.. masked — fires stop at 125, target <= 126 < n-1 for
        # n = 132; with n = 128+4 pad the tail positions keep a0v
        r1f = a0v
        return r1f, (r1f, fire, ew, ev, outer)

    return step


def very_low_q_cleanup_device(plane, quality: int, xs7: tuple):
    """models/encoder._very_low_q_cleanup on (B,512,512) int16 planes,
    bit-exact (tests).  xs7 = (x1..x7) from _VLQ_THRX."""
    from nhwcodec_tpu import tables as T

    x1, x2, x3, x4, x5, x6, x7 = xs7
    low9 = quality <= T.LOW9
    I0 = jnp.asarray(plane).astype(jnp.int32)
    b = I0.shape[0]

    # ---------- pass 1 (row-parallel sequential column scans) ----------
    reg = I0[:, :128, :128]
    pad = jnp.concatenate(
        [reg, I0[:, :128, 128:132]], axis=2)      # flat reads j+4 < 132
    arrs = tuple(_flat_shift_l(pad, k) for k in range(5)) + (
        jnp.broadcast_to(jax.lax.broadcasted_iota(
            jnp.int32, (132,), 0), pad.shape),)
    fw, wv, fany1 = _vlq_row_scan(_vlq_p1_row(x1, x2), arrs, b)
    # writes land at j+2
    w_at = _flat_shift_r(fw, 2, False)
    v_at = _flat_shift_r(wv, 2)
    ll1 = jnp.where(w_at, v_at, pad)[:, :, :128]
    out = I0.at[:, :128, :128].set(ll1)
    any_p1 = jnp.any(fany1.reshape(b, -1), axis=1)

    # ---------- passes 2 and 3 (row scans over rows 0..125) ----------
    def run_p23(cur, variant):
        regp = cur[:, :129, :132]
        xs_rows = (jnp.swapaxes(regp[:, 1:127], 0, 1),
                   jnp.swapaxes(regp[:, 2:128], 0, 1))
        row0 = regp[:, 0]
        _, ys = jax.lax.scan(_vlq_p23_step(x3, x4, variant), row0,
                             xs_rows)
        r1f, fire, ew, ev, outer = (jnp.swapaxes(y, 0, 1) for y in ys)
        # write back rows 1..126 (visits r=0..125 write row r+1)
        out2 = cur.at[:, 1:127, :132].set(r1f)
        return out2, fire, outer

    out, fire2, hit2 = run_p23(out, 2)
    out, fire3, hit3 = run_p23(out, 3)

    # ---------- pass 4 (parallel; low9 only) ----------
    if low9:
        r4 = out[:, :128, :132]
        d01 = jnp.abs(_flat_shift_l(r4, 2) - _flat_shift_l(r4, 1))
        d02 = jnp.abs(_flat_shift_l(r4, 2) - r4)
        d12 = jnp.abs(_flat_shift_l(r4, 1) - r4)
        jc4 = jax.lax.broadcasted_iota(jnp.int32, (132,), 0)
        fire4 = (jc4 < 126) & (d01 < x7) & (d02 < x7) & (d12 < x7)
    else:
        fire4 = jnp.zeros((b, 128, 132), bool)

    # ---------- apply the far zeroings ----------
    # fire positions are (row r, col j) with targets keyed by
    # count_pos = r*512 + j (+k).  Families:
    #  A: zero_bands(cnt, x5-or-32, x6, e34=False) at p1 (cnt=j+1..3),
    #     p2/p3 (cnt = fire col j+1 .. the write target col)
    #  B: zero_bands(cnt, 34, x6, e34=True) at pass 4 (cnt = j+1)
    #  C: zero_l2(cnt)
    def rowdown(m):
        # pass-2/3 fires at visit (r, j), r in 0..125, target count
        # positions at (r+1, j+1): embed into the 128-row frame shifted
        # down one row and right one col
        return _zpad(_flat_shift_r(m, 1, False), [(-2, (1, 1))], False)

    fz = jnp.zeros((b, 128, 132), bool)   # x5-threshold band fires (p1)
    for k in (1, 2, 3):
        fz = fz | _flat_shift_r(fany1, k, False)
    f32 = rowdown(fire2) | rowdown(fire3)  # 32-threshold fires (p2/p3)
    fe34 = _flat_shift_r(fire4, 1, False)  # pass-4 fires (thr 34, e34)
    fl2 = jnp.zeros((b, 128, 132), bool)   # zero_l2 fires
    if low9:
        for k in (1, 2, 3):
            fl2 = fl2 | _flat_shift_r(fany1, k, False)
        # passes 2/3 zero_l2 at carry-1..carry+1 around the fresh fire
        # position (r+1, j+1); pass 3 additionally applies at the
        # INHERITED carry when a second-level hit precedes its first
        # fire (handled after the mask families)
        d23 = rowdown(fire2) | rowdown(fire3)
        fl2 = fl2 | d23 | _flat_shift_r(d23, 1, False) \
            | _flat_shift_l(d23, 1, False)
        fl2 = fl2 | _flat_shift_r(fire4, 1, False)

    def zero_bands(pl, mask, thr_p1, x6_, e_thr):
        """_vlq_zero_bands: for count_pos positions in mask (cols 0..127
        of rows 0..127), zero the derived band positions."""
        flat = pl.reshape(b, -1)
        m = mask[:, :, :128]
        rows = jax.lax.broadcasted_iota(jnp.int32, (128, 128), 0)
        cols = jax.lax.broadcasted_iota(jnp.int32, (128, 128), 1)
        c2 = (rows * 512 + cols) * 2
        for off, thr in (((256, 257, 768, 769), x6_),
                         ((2 * SZ, 2 * SZ + 1, 2 * SZ + 512,
                           2 * SZ + 513), x6_ + 6),
                         ((2 * SZ + 256, 2 * SZ + 257, 2 * SZ + 256 + 512,
                           2 * SZ + 257 + 512), e_thr)):
            for o in off:
                idx = (c2 + o).reshape(-1)
                tgt = jnp.take_along_axis(
                    flat, jnp.broadcast_to(idx, (b, idx.size)), axis=1
                ).reshape(b, 128, 128)
                hit = m & (jnp.abs(tgt) < thr)
                upd = jnp.where(hit, 0, tgt).reshape(b, -1)
                flat = jax.vmap(lambda f, u, ii=idx: f.at[ii].set(u))(
                    flat, upd)
        return flat.reshape(pl.shape)

    out = zero_bands(out, fz, x5, x6, x5)
    out = zero_bands(out, f32, 32, x6, 32)
    if low9:
        out = zero_bands(out, fe34, 34, x6, 34)

        # zero_l2 targets: count_pos + 128, + SZ, + SZ + 128
        flat = out.reshape(b, -1)
        m = fl2[:, :, :128]
        rows = jax.lax.broadcasted_iota(jnp.int32, (128, 128), 0)
        cols = jax.lax.broadcasted_iota(jnp.int32, (128, 128), 1)
        cp = rows * 512 + cols
        for o, thr in ((128, 11), (SZ, 12), (SZ + 128, 13)):
            idx = (cp + o).reshape(-1)
            tgt = jnp.take_along_axis(
                flat, jnp.broadcast_to(idx, (b, idx.size)), axis=1
            ).reshape(b, 128, 128)
            hit = m & (jnp.abs(tgt) < thr)
            upd = jnp.where(hit, 0, tgt).reshape(b, -1)
            flat = jax.vmap(lambda f, u, ii=idx: f.at[ii].set(u))(
                flat, upd)
        out = flat.reshape(out.shape)

        # pass-3's STALE-carry zero_l2: hits at the second level re-use
        # the inherited carry until pass 3's own first fire.  Re-
        # applications at pass-2/3 fire positions are no-ops (the
        # zeroing is absorbing with fixed thresholds); the only fresh
        # effect is the inherited carry==4 (any pass-1 fire, no pass-2
        # fire) or carry==0 case.
        def first_pos(m):
            mm = m.reshape(b, -1)
            return (jnp.where(jnp.any(mm, axis=1),
                              jnp.argmax(mm, axis=1), 1 << 30),
                    jnp.any(mm, axis=1))

        hpos, hhas = first_pos(hit3)
        fpos, _ = first_pos(fire3)
        any_p2 = jnp.any(fire2.reshape(b, -1), axis=1)
        stale = hhas & (hpos < fpos) & ~any_p2
        use4 = stale & any_p1
        use0 = stale & ~any_p1
        flat = out.reshape(b, -1)
        for cnts, cond in (((3, 4, 5), use4), ((-1, 0, 1), use0)):
            for cnt in cnts:
                for o, thr in ((128, 11), (SZ, 12), (SZ + 128, 13)):
                    ix = cnt + o
                    v = flat[:, ix]
                    flat = flat.at[:, ix].set(
                        jnp.where(cond & (jnp.abs(v) < thr), 0, v))
        out = flat.reshape(out.shape)

    return out.astype(jnp.int16)


# ---------------------------------------------------------------------------
# E14 low-q: offset_y with the duty-cycle counters (q <= LOW4), as an
# exact flat lax.scan — the counters (quant mod 6 / quant6 mod 4 per
# row, quant4 mod 3 global) plus the single forward-write slot are the
# whole sequential state; pf[i-1] reads are provably r1 == 0 (every
# emitted code and fixup value is >= -9 with (|v|&7) < 6), and all
# other neighbour reads are initial values.


def _oy4_tables():
    from nhwcodec_tpu.ops.quantize import EXTRA_WORDS1, EXTRA_WORDS2

    return (jnp.asarray(EXTRA_WORDS1, jnp.int32),
            jnp.asarray(EXTRA_WORDS2, jnp.int32))


def _oy4_step(m1: int):
    e1t, e2t = _oy4_tables()

    def step(carry, x):
        quant, quant6, quant4, pend_on, pend_val = carry
        i0, i1, i2, col, reg4 = x
        row0 = col == 0
        quant = jnp.where(row0, 0, quant)
        quant6 = jnp.where(row0, 0, quant6)

        a0 = jnp.where(pend_on, pend_val, i0)
        zero = a0 == 0
        sent = a0 > 10000
        escp = (~sent) & (a0 > 127)
        escn = a0 < -127
        plain = ~(zero | sent | escp | escn)
        incol = col < 2 * D - 1

        # fixup writes to i+1 (sequential order mirrors the host)
        w_m9 = plain & (a0 < -12) & (((-a0) & 7) == 6) & incol \
            & (i1 == -7)
        neg = a0 < 0
        selfm8 = plain & neg & (a0 == -7) & (i1 == 8) & incol
        a1 = jnp.where(selfm8, -8, a0)
        an = -a1
        dec2 = (an > 14) & ((an & 7) == 7) & (i1 > 0) & (i1 < 8)
        an = jnp.where(dec2, an - 2, an)
        # low4 duty cycles on the negated magnitude
        is15 = an == 15
        is22 = (~is15) & (an > 22) & ((an & 7) == 7)
        mask_now15 = is15 & (quant == 0)
        mask_now22 = is22 & (quant6 == 0)
        an2 = jnp.where(is15,
                        jnp.where(mask_now15, an & 504, an),
                        jnp.where(is22,
                                  jnp.where(mask_now22, an & 504, an),
                                  an & 504))
        negq = jnp.where(plain & neg, -an2, a1)
        qn = jnp.where(plain & neg & is15,
                       jnp.where(quant == 0, 1, (quant + 1) % 6), quant)
        q6n = jnp.where(plain & neg & is22,
                        jnp.where(quant6 == 0, 1, (quant6 + 1) % 4),
                        quant6)

        w_m8 = plain & ~neg & (a0 == 8) & (i1 == -7) & incol
        w_9 = plain & ~neg & ~(a0 == 8) & (a0 > 12) & ((a0 & 7) >= 6) \
            & incol & (i1 == 7)

        a2 = jnp.where(plain & neg, negq, a0)
        # quant4 pair balancing (i1 unchanged when a fixup fired — the
        # fixup values are < 14, which kills the block)
        fixed = w_m9 | w_m8 | w_9
        blk = plain & ~fixed & (a2 >= 14) & (i1 >= 14) & reg4
        q2 = a2 & 510
        q3 = i1 & 510
        pairok = blk & ((q2 & 7) == 6) & ((q3 & 7) == 6) \
            & (((a2 & 1) == 1) | ((i1 & 1) == 1))
        edge = (col > 0) & (col < 2 * D - 2)
        vp = i2
        r2 = jnp.where((vp > -8) & (vp < -2), 1,
                       jnp.where(vp < -7,
                                 jnp.where(((-vp) & 7) < 6, 0, 1), 0))
        r2 = jnp.where(edge, r2, 0)
        fire4 = pairok & (quant4 == 0)
        same = (a2 & 504) == (i1 & 504)
        gebr = a2 >= i1
        # r1 == 0 always; branch outcomes:
        up_a = fire4 & (same & gebr | (~same & (a2 <= i1)))
        up_b = fire4 & ~up_a & (r2 == 0)  # pend = b + 2
        a3 = jnp.where(up_a, a2 + 2, a2)
        pend4 = up_a | up_b
        pend4v = jnp.where(up_a, i1 - 2, i1 + 2)
        q4n = jnp.where(pairok,
                        jnp.where(quant4 == 0, 1, (quant4 + 1) % 3),
                        quant4)

        code = jnp.where((a3 > -m1) & (a3 < m1), 128, (a3 + 128) & 248)
        out = jnp.where(zero, 128,
                        jnp.where(sent, _sentinel_code(a0),
                                  jnp.where(escp | escn,
                                            _escape_code(a0), code)))

        pend_on2 = plain & (w_m9 | w_m8 | w_9 | pend4)
        pend_v2 = jnp.where(w_m9, -9,
                            jnp.where(w_m8, -8,
                                      jnp.where(w_9, 9, pend4v)))
        carry2 = (jnp.where(plain, qn, quant),
                  jnp.where(plain, q6n, quant6),
                  jnp.where(plain, q4n, quant4),
                  pend_on2, pend_v2)
        return carry2, out

    return step


def offset_y_low4_device(plane, m1: int = 8):
    """ops.quantize.offset_y for q <= LOW4 on (B,512,512) int16: the
    pair-decrement pass 1 (Jacobi) then the duty-cycle quantizer as one
    exact 262144-step scan (correctness-first; the counters are
    irreducibly sequential)."""
    b = plane.shape[0]
    If = jnp.asarray(plane).astype(jnp.int32).reshape(b, -1)
    If = _offset_y_pass1(If)
    pad = jnp.concatenate([If, jnp.zeros((b, 8), jnp.int32)], axis=1)
    n = 4 * SZ
    idx = jnp.arange(n, dtype=jnp.int32)
    col = idx & 511
    reg4 = (idx >= 2 * SZ) | (col >= D)   # the quant4 region test
    xs = (pad[:, :n].T, pad[:, 1:n + 1].T, pad[:, 2:n + 2].T,
          jnp.broadcast_to(col[:, None], (n, b)),
          jnp.broadcast_to(reg4[:, None], (n, b)))
    z = jnp.zeros((b,), jnp.int32)
    carry0 = (z, z, z, jnp.zeros((b,), bool), z)
    _, outs = jax.lax.scan(_oy4_step(m1), carry0, xs)
    return outs.T.reshape(plane.shape).astype(jnp.int16)


@functools.partial(jax.jit, static_argnames=("thrx2",))
def low56_band_cleanup_device(plane, thrx2: int):
    """models/encoder._low56_band_cleanup (q in {LOW6, LOW5}) — pure
    elementwise dead-zoning of the lower half."""
    I = jnp.asarray(plane).astype(jnp.int32)
    left = I[:, 256:, :256]
    av = jnp.abs(left)
    left2 = jnp.where((av >= 8) & (av < 11), 0, left)
    right = I[:, 256:, 256:]
    av = jnp.abs(right)
    m = (av >= 8) & (av < thrx2)
    right2 = jnp.where(m, jnp.where(right >= 14, 7,
                                    jnp.where(right <= -14, -7, 0)),
                       right)
    return (I.at[:, 256:, :256].set(left2)
            .at[:, 256:, 256:].set(right2).astype(jnp.int16))
