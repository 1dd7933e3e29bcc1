/* Native hot-pass kernels for the NHW host pipeline.
 *
 * These mirror the verified Python implementations in ops/ (same
 * behavior contracts, cited there against the reference file:line); the
 * raster-carried scans are irreducibly sequential, so the host runtime
 * runs them natively while the plane transforms run on the device.
 */
#include <pthread.h>
#include <stdint.h>
#include <string.h>

#define D 256
#define N 512
#define SZ 65536

/* ------------------------------------------------------------------ */
/* Huffman packetizer stages (ops/entropy_enc.py)                      */

void nhw_histogram(const uint8_t *s, long p1, long p2,
                   int64_t *rle_buf, int64_t *rle_128)
{
    long i = p1;
    int e = 1, c = 0;
    while (i < p2 - 1) {
        if (s[i] == 128) {
            while (i < p2 - 1 && s[i + 1] == 128) {
                e += 1;
                c = 1;
                if (e > 255) { rle_128[254] += 1; e = 1; c = 0; continue; }
                i += 1;
            }
        }
        if (c) rle_128[e] += 1; else rle_buf[s[i]] += 1;
        e = 1; c = 0;
        i += 1;
    }
}

/* returns the final word index `a`; in/out: words, pack, sel counters */
long nhw_emit(const uint8_t *s, long p1, long p2, int select, int zone,
              const int32_t *sym_pos, const int32_t *run_pos,
              const uint32_t *codes, const int32_t *lens,
              uint32_t *words, long words_cap, long a_in, int pack_in,
              uint8_t *sel1_bits, long *n_sel1,
              uint8_t *sel2_bits, long *n_sel2,
              int *pack_out)
{
    long i = p1, a = a_in;
    int pack = pack_in, e = 1, tag = 0;
    long c1 = *n_sel1, c2 = *n_sel2;
    /* 64-bit packing window: the top `pack` bits are the current
     * word-in-progress (resumed from the caller's partial word); a
     * word is flushed only when pack exceeds 32, preserving the
     * original lazy advance (an exactly-full word stays at index a,
     * which the size_data accounting depends on). */
    uint64_t acc = ((uint64_t)words[a]) << 32;

    /* plain-literal fast path: per-pixel code+length with the zone
     * remap folded in (runs, selects and the 121-135 specials keep the
     * general path; 256-entry setup per call is noise) */
    uint32_t pc[256];
    int pl[256];
    {
        int p;
        for (p = 0; p < 256; p++) {
            int pos = sym_pos[p];
            pl[p] = 0;
            if (p == 128 || (p > 120 && p < 136) || p == 153 || p == 155
                || p == 157 || p == 159)
                continue;
            if (pos < 0 || pos >= 354)
                continue;  /* pixel absent from the alphabet */
            if (pos >= 110 && pos < 174 && zone) {
                pc[p] = 64u | (uint32_t)(pos - 110); pl[p] = 15;
            } else {
                int q = pos;
                if (q >= 174 && zone) q -= 64;
                pc[p] = codes[q]; pl[p] = lens[q];
            }
        }
    }

    while (i < p2 - 1) {
        int pixel = s[i];
        if (pl[pixel]) {
            pack += pl[pixel];
            acc |= (uint64_t)pc[pixel] << (64 - pack);
            if (pack > 32) {
                words[a] = (uint32_t)(acc >> 32);
                a += 1;
                if (a >= words_cap) return -1;
                acc <<= 32;
                pack -= 32;
            }
            i += 1;
            continue;
        }
        if (pixel == 153) { sel1_bits[c1++] = 0; i++; continue; }
        if (pixel == 155) { sel1_bits[c1++] = 1; i++; continue; }
        if (pixel == 157) { sel2_bits[c2++] = 0; i++; continue; }
        if (pixel == 159) { sel2_bits[c2++] = 1; i++; continue; }

        int pos;
        if (pixel != 128 && pixel > 120 && pixel < 136) {
            pos = sym_pos[pixel];
            if (pixel > 131) i += 4;
        } else {
            if (pixel == 128) {
                int overflow = 0;
                while (i < p2 - 1 && s[i + 1] == 128) {
                    e += 1;
                    if (e > 255) { e = 254; i -= 1; overflow = 1; break; }
                    i += 1;
                }
                if (!overflow && e > 1 && e < select) {
                    i -= e - 1; tag = e; e = 1;
                }
            }
            pos = (e == 1) ? sym_pos[pixel] : run_pos[e];
        }

        for (;;) {
            uint32_t code; int nb;
            if (pos >= 110 && pos < 174 && zone) {
                code = 64u | (uint32_t)(pos - 110); nb = 15;
            } else {
                int p = pos;
                if (p >= 174 && zone) p -= 64;
                code = codes[p]; nb = lens[p];
            }
            pack += nb;
            acc |= (uint64_t)code << (64 - pack);
            if (pack > 32) {
                words[a] = (uint32_t)(acc >> 32);
                a += 1;
                if (a >= words_cap) return -1;  /* caller raises */
                acc <<= 32;
                pack -= 32;
            }
            e = 1;
            if (tag > 0) {
                tag -= 1;
                if (tag > 0) { i += 1; pos = sym_pos[128]; continue; }
            }
            break;
        }
        i += 1;
    }
    words[a] = (uint32_t)(acc >> 32);
    *n_sel1 = c1; *n_sel2 = c2; *pack_out = pack;
    return a;
}

/* The same symbol walk as nhw_emit, but emitting codebook-position
 * tokens instead of packed bits: the packing itself then runs as a
 * parallel prefix program on device (ops/entropy_device.py).  Select
 * side-bits are collected identically. */
long nhw_tokenize(const uint8_t *s, long p1, long p2, int select,
                  uint8_t *sel1_bits, long *n_sel1,
                  uint8_t *sel2_bits, long *n_sel2,
                  int32_t *tokens, long tokens_cap)
{
    long i = p1, n = 0;
    int e = 1, tag = 0;
    long c1 = *n_sel1, c2 = *n_sel2;

    while (i < p2 - 1) {
        int pixel = s[i];
        if (pixel == 153) { sel1_bits[c1++] = 0; i++; continue; }
        if (pixel == 155) { sel1_bits[c1++] = 1; i++; continue; }
        if (pixel == 157) { sel2_bits[c2++] = 0; i++; continue; }
        if (pixel == 159) { sel2_bits[c2++] = 1; i++; continue; }

        int pos;
        if (pixel != 128 && pixel > 120 && pixel < 136) {
            pos = -(pixel + 1);   /* marker: resolve via sym_pos on host */
            if (pixel > 131) i += 4;
        } else {
            if (pixel == 128) {
                int overflow = 0;
                while (i < p2 - 1 && s[i + 1] == 128) {
                    e += 1;
                    if (e > 255) { e = 254; i -= 1; overflow = 1; break; }
                    i += 1;
                }
                if (!overflow && e > 1 && e < select) {
                    i -= e - 1; tag = e; e = 1;
                }
            }
            pos = (e == 1) ? -(pixel + 1) : (65536 + e);
        }

        for (;;) {
            if (n >= tokens_cap) return -1;
            tokens[n++] = pos;
            e = 1;
            if (tag > 0) {
                tag -= 1;
                if (tag > 0) { i += 1; pos = -(128 + 1); continue; }
            }
            break;
        }
        i += 1;
    }
    *n_sel1 = c1; *n_sel2 = c2;
    return n;
}

/* ------------------------------------------------------------------ */
/* offsetY (ops/quantize.py: the four passes)                          */

static const int EXW1[19] = {10,12,14,18,20,22,26,28,30,34,36,38,42,44,46,
                             50,52,54,58};
static const int EXW2[19] = {60,62,66,68,70,74,76,78,82,84,86,90,92,94,98,
                             100,102,106,108};

/* Pass-4 fast-path LUT: maps an int16 coefficient straight to its
 * quantized output when the mapping is provably independent of the
 * neighbors and the duty-cycle counters; OFFSET_LUT_SLOW marks values
 * that must run the original scan body.  Trigger classes (see the
 * scan): a==-7 / a==8 (pair rewrites), a<-12 with (-a)&7>=6 (writes
 * or reads pf[i+1]), a>12 with a&7>=6 (writes pf[i+1]), and under
 * low4 every |a|>=14 (quant/quant6/quant4 ladder advance sites). */
#define OFFSET_LUT_SLOW ((int16_t)-32768)
/* One immutable slot per low4 mode, each built ONCE (under the lock)
 * for the first m1 seen and never modified afterwards — concurrent
 * scans with different qualities can therefore never observe a
 * half-rebuilt table.  A call with a different m1 than the slot was
 * built for simply runs the original scan body (m1 is the dead-zone
 * `ratio`, fixed at 8 by the CLI contract, so in practice the slots
 * build once per process). */
static int16_t offset_y_lut[2][65536];
static int offset_y_lut_m1[2] = {-1, -1};
static pthread_mutex_t offset_y_lut_mu = PTHREAD_MUTEX_INITIALIZER;

/* returns 1 iff the slot for this (m1, low4) is built and usable */
static int nhw_build_offset_y_lut(int m1, int low4)
{
    long v;
    int usable;
    int16_t *lut = offset_y_lut[low4];
    if (offset_y_lut_m1[low4] == m1) return 1;
    pthread_mutex_lock(&offset_y_lut_mu);
    if (offset_y_lut_m1[low4] != -1) {
        usable = offset_y_lut_m1[low4] == m1;
        pthread_mutex_unlock(&offset_y_lut_mu);
        return usable;
    }
    for (v = -32768; v <= 32767; v++) {
        uint16_t idx = (uint16_t)v;
        int a = (int)v;
        if (a == -7 || a == 8
            || (a < -12 && (((-a) & 7) >= 6))
            || (a > 12 && ((a & 7) >= 6) && a <= 10000)
            || (low4 && (a >= 14 || a <= -14) && a <= 10000)) {
            lut[idx] = OFFSET_LUT_SLOW;
            continue;
        }
        if (a > 10000) {
            int r = a;
            switch (a) {
            case 10100: r = 128; break;
            case 12700: r = 127; break;
            case 12900: r = 129; break;
            case 10204: r = 125; break;
            case 10300: r = 126; break;
            case 12100: r = 121; break;
            case 12200: r = 122; break;
            }
            lut[idx] = (int16_t)r;
            continue;
        }
        if (a > 127) {
            int exw = ((a & 0xfff8) - 128) >> 3;
            lut[idx] = (int16_t)EXW1[exw > 18 ? 18 : exw];
            continue;
        }
        if (a < -127) {
            int exw = (((-a) & 0xfff8) - 128) >> 3;
            lut[idx] = (int16_t)EXW2[exw > 18 ? 18 : exw];
            continue;
        }
        if (a < 0) {
            a = -a;
            if (low4) a &= 504;
            else if ((a & 7) < 7) a &= 504;
            a = -a;
        }
        if (a < m1 && a > -m1) { lut[idx] = 128; continue; }
        a += 128;
        lut[idx] = (int16_t)(a & 248);
    }
    offset_y_lut_m1[low4] = m1;  /* publish last (x86 TSO) */
    pthread_mutex_unlock(&offset_y_lut_mu);
    return 1;
}

void nhw_offset_y(int16_t *pf, int quality, int m1, int low4)
{
    long i;
    /* pass 1: even-pair decrements in the bands.  Candidates need
     * BOTH pair members > 7; the pass only ever decrements, so a
     * vectorizable pre-screen on the original values is a safe
     * superset and skips the (typically sparse) quiet majority. */
    /* thread-local scratch: the chunk pipeline runs these scans from
     * worker threads, so plain function-static buffers would race */
    static __thread uint8_t gt[4 * SZ + 8];
    for (i = 0; i < 4 * SZ; i++)
        gt[i] = pf[i] > 7;
    memset(gt + 4 * SZ, 0, 8);
    for (i = 0; i < 4 * SZ; ) {
        /* word-skip: the pass only ever decrements, so the pre-pass
         * gt[] mask stays a superset of live candidates — 8 zero
         * pair-ANDs mean 8 skippable positions in one load */
        if (!(i & 7)) {
            uint64_t w1, w2;
            memcpy(&w1, gt + i, 8);
            memcpy(&w2, gt + i + 1, 8);
            if (!(w1 & w2)) { i += 8; continue; }
        }
        if (!(gt[i] & gt[i + 1])) { i++; continue; }
        if (!(i >= 2 * SZ || (i & 511) >= D)) { i++; continue; }
        if ((i & 511) >= 2 * D - 1) { i++; continue; }
        int a = pf[i];
        if (a > 7 && pf[i + 1] > 7) {
            if (!(a & 7) && !(pf[i + 1] & 7)) {
                if (a > 15) {
                    if (i > 0) {
                        if (pf[i - 1] <= 0) pf[i] = a - 1;
                        else if (pf[i + 1] > 15) {
                            if ((i & 511) < 2 * D - 2 && pf[i + 2] <= 0)
                                pf[i + 1] -= 1;
                        }
                    }
                } else if (pf[i + 1] > 15) {
                    if ((i & 511) < 2 * D - 2 && pf[i + 2] <= 0)
                        pf[i + 1] -= 1;
                }
            }
        }
        i++;
    }

    /* passes 2 + 3: pair promotions, q>LOW4.  Prescreen: any action
     * requires BOTH pf[a0] and pf[a0-1] (pass 2) / pf[a0+1] (pass 3)
     * inside small magnitude windows; the passes only write sentinel
     * values >10000 (never inside those windows), so a pre-pass
     * candidate mask is a stable superset and 8 positions skip on one
     * zero word. */
    if (!low4) {
        long r, j;
        static __thread uint8_t cnd[D + 8];
        for (r = 0; r < D; r++) {
            long base = r * N;
            for (j = 0; j < D; j++) {
                int v = pf[base + j];
                cnd[j] = (v > 3 && v < 8) | (v < -3 && v > -8);
            }
            memset(cnd + D, 0, 8);
            for (j = 1; j < D - 1; ) {
                if (!(j & 7)) {
                    uint64_t w1, w2;
                    memcpy(&w1, cnd + j, 8);
                    memcpy(&w2, cnd + j - 1, 8);
                    if (!(w1 & w2)) { j += 8; continue; }
                }
                if (!(cnd[j] & cnd[j - 1])) { j++; continue; }
                long a0 = base + j;
                int v = pf[a0];
                if (v > 3 && v < 8) {
                    if (pf[a0-1] > 3 && pf[a0-1] <= 7) {
                        if (pf[a0+1] > 3 && pf[a0+1] <= 7) {
                            pf[a0] = 12700; pf[a0-1] = 10100; j += 1;
                        } else if (pf[a0+N-1] > 3 && pf[a0+N-1] <= 7
                                   && pf[a0+N] > 3 && pf[a0+N] <= 7) {
                            pf[a0-1] = 12100; pf[a0] = 10100;
                            pf[a0+N-1] = 10100; pf[a0+N] = 10100; j += 1;
                        }
                    }
                } else if (v < -3 && v > -8) {
                    if (pf[a0-1] < -3 && pf[a0-1] >= -7) {
                        if (pf[a0+1] < -3 && pf[a0+1] >= -7) {
                            pf[a0] = 12900; pf[a0-1] = 10100; j += 1;
                        } else if (pf[a0+N-1] < -3 && pf[a0+N-1] >= -7
                                   && pf[a0+N] < -3 && pf[a0+N] >= -7) {
                            pf[a0-1] = 12200; pf[a0] = 10100;
                            pf[a0+N-1] = 10100; pf[a0+N] = 10100; j += 1;
                        }
                    }
                }
                j++;
            }
        }
        /* pass 3: same prescreen, windows |v| in [5,7] at j and j+1 */
        for (r = 0; r < D; r++) {
            long base = r * N;
            for (j = 0; j < D; j++) {
                int v = pf[base + j];
                cnd[j] = (v >= 5 && v <= 7) | (v <= -5 && v >= -7);
            }
            memset(cnd + D, 0, 8);
            for (j = 0; j < D - 1; ) {
                if (!(j & 7)) {
                    uint64_t w1, w2;
                    memcpy(&w1, cnd + j, 8);
                    memcpy(&w2, cnd + j + 1, 8);
                    if (!(w1 & w2)) { j += 8; continue; }
                }
                if (!(cnd[j] & cnd[j + 1])) { j++; continue; }
                long a0 = base + j;
                int v = pf[a0], w = pf[a0+1];
                if (v >= 5 && v <= 7 && w >= 5 && w <= 7) {
                    pf[a0] = 10300; j += 1;
                } else if (v <= -5 && v >= -7 && w <= -5 && w >= -7) {
                    pf[a0] = 10204; j += 1;
                }
                j++;
            }
        }
    }

    /* pass 4: the quantizer.  The mapping is elementwise except for a
     * small set of neighbor-coupled trigger values (and, under low4,
     * the counter ladders, all of whose advance sites require
     * |a| >= 14) — so a 64K LUT over the int16 input resolves the
     * common case in one predictable load, with a sentinel routing
     * the trigger values to the exact original scan body. */
    {
        int quant = 0, quant6 = 0, quant4 = 0;
        int use_lut = nhw_build_offset_y_lut(m1, low4);
        const int16_t *lut = offset_y_lut[low4];
        for (i = 0; i < 4 * SZ; i++) {
            if (!(i & 511)) { quant = 0; quant6 = 0; }
            if (use_lut) {
                int16_t fv = lut[(uint16_t)pf[i]];
                if (fv != OFFSET_LUT_SLOW) { pf[i] = fv; continue; }
            }
            int a = pf[i];
            if (a > 10000) {
                switch (a) {
                case 10100: pf[i] = 128; break;
                case 12700: pf[i] = 127; break;
                case 12900: pf[i] = 129; break;
                case 10204: pf[i] = 125; break;
                case 10300: pf[i] = 126; break;
                case 12100: pf[i] = 121; break;
                case 12200: pf[i] = 122; break;
                }
                continue;
            }
            if (a > 127) {
                int exw = ((a & 0xfff8) - 128) >> 3;
                pf[i] = EXW1[exw > 18 ? 18 : exw];
                continue;
            }
            if (a < -127) {
                int exw = (((-a) & 0xfff8) - 128) >> 3;
                pf[i] = EXW2[exw > 18 ? 18 : exw];
                continue;
            }
            if (a < -12 && (((-a) & 7) == 6)) {
                if ((i & 511) < 2 * D - 1 && pf[i + 1] == -7) pf[i + 1] = -9;
            }
            if (a < 0) {
                if (a == -7 && pf[i + 1] == 8 && (i & 511) < 2 * D - 1) {
                    pf[i] = -8; a = -8;
                }
                a = -a;
                if (a > 14 && (a & 7) == 7 && pf[i+1] > 0 && pf[i+1] < 8)
                    a -= 2;
                if (low4) {
                    if (a == 15) {
                        if (!quant) { a &= 504; quant = 1; }
                        else quant = (quant + 1) % 6;
                    } else if (a > 22 && (a & 7) == 7) {
                        if (!quant6) { a &= 504; quant6 = 1; }
                        else quant6 = (quant6 + 1) % 4;
                    } else a &= 504;
                } else {
                    if ((a & 7) < 7) a &= 504;
                }
                a = -a;
            } else if (a == 8 && pf[i + 1] == -7 && (i & 511) < 2 * D - 1) {
                pf[i + 1] = -8;
            } else if (a > 12 && (a & 7) >= 6) {
                if ((i & 511) < 2 * D - 1 && pf[i + 1] == 7) pf[i + 1] = 9;
            }

            if (a >= 14 && pf[i + 1] >= 14 && low4) {
                if (i >= 2 * SZ || (i & 511) >= D) {
                    int q2 = a & 510, q3 = pf[i + 1] & 510;
                    if ((q2 & 7) == 6 && (q3 & 7) == 6
                        && ((a & 1) == 1 || (pf[i + 1] & 1) == 1)) {
                        int r1 = 0, r2 = 0;
                        if ((i & 511) > 0 && (i & 511) < 2 * D - 2) {
                            int vm = pf[i - 1];
                            if (vm > -8 && vm < -2) r1 = 1;
                            else if (vm < -7) r1 = (((-vm) & 7) < 6) ? 0 : 1;
                            int vp = pf[i + 2];
                            if (vp > -8 && vp < -2) r2 = 1;
                            else if (vp < -7) r2 = (((-vp) & 7) < 6) ? 0 : 1;
                        }
                        if (!quant4) {
                            int b = pf[i + 1];
                            if ((a & 504) == (b & 504)) {
                                if (a >= b) {
                                    if (!r1) { a += 2; pf[i + 1] = b - 2; }
                                } else if (!r2) pf[i + 1] = b + 2;
                            } else if (a <= b) {
                                if (!r1) { a += 2; pf[i + 1] = b - 2; }
                            } else if (!r2) pf[i + 1] = b + 2;
                            quant4 = 1;
                        } else quant4 = (quant4 + 1) % 3;
                    }
                }
            }
            if (a < m1 && a > -m1) { pf[i] = 128; continue; }
            a += 128;
            pf[i] = a & 248;
        }
    }
}

/* ------------------------------------------------------------------ */
/* band snap/dead-zone pass (models/encoder.py _band_snap_pass)        */

void nhw_snap_pass(int16_t *pf, int r0, int r1_, int col0, int col1,
                   int ratio_thr, int y_wavelet, int y_wavelet2,
                   int second_rule, int snap_guard6, int guard_col)
{
    int r, j;
    for (r = r0; r < r1_; r++) {
        long base = (long)r * N;
        for (j = col0; j < col1; j++) {
            long a0 = base + j;
            int v = pf[a0];
            if (v >= ratio_thr || v <= -ratio_thr) {
                int av = v < 0 ? -v : v;
                if (av < y_wavelet2) {
                    int cnt = 0;
                    int t;
                    t = pf[a0-1]; if ((t<0?-t:t) + 2 >= 8) cnt++;
                    t = pf[a0+1]; if ((t<0?-t:t) + 2 >= 8) cnt++;
                    t = pf[a0-N]; if ((t<0?-t:t) + 2 >= 8) cnt++;
                    t = pf[a0+N]; if ((t<0?-t:t) + 2 >= 8) cnt++;
                    if (cnt < 3 && v > -y_wavelet && v < y_wavelet) {
                        if (snap_guard6) {
                            if (v < -6) pf[a0] = -7;
                            else if (v > 6) pf[a0] = 7;
                        } else pf[a0] = v < 0 ? -7 : 7;
                    } else if (second_rule && !cnt && av < y_wavelet2) {
                        pf[a0] = v < 0 ? -7 : 7;
                    }
                }
            } else pf[a0] = 0;

            {
                int e = pf[a0];
                int ae = e < 0 ? -e : e;
                if (ae > 6) {
                    if (e >= 8 && (e & 7) < 2) {
                        if (pf[a0+1] > 7 && pf[a0+1] < 10000) pf[a0+1] -= 1;
                    } else if (e == -7 && pf[a0+1] == 8) {
                        pf[a0] = -8;
                    } else if (e == 8 && pf[a0+1] == -7) {
                        pf[a0+1] = -8;
                    } else if (e < -7 && (((-e) & 7) < 2)) {
                        int n1v = pf[a0+1];
                        if (n1v < -14 && n1v < 10000) {
                            if (((-n1v) & 7) == 7) pf[a0+1] = n1v + 1;
                            else if ((((-n1v) & 7) < 2) && j < guard_col
                                     && pf[a0+2] <= 0)
                                pf[a0+1] = n1v + 1;
                        }
                    }
                }
            }
        }
    }
}

/* ------------------------------------------------------------------ */
/* res256 column ladder + classify (ops/residue.py)                   */

static void band_w1(int16_t *pf, long st)
{
    int v = pf[st];
    if (v == 7) { if (pf[st-1] >= 0 && pf[st-1] < 8) pf[st] = v + 2; }
    else if (v == 8) { if (pf[st-1] >= -2 && pf[st-1] < 8) pf[st] = v + 2; }
}

static void band_w2(int16_t *pf, long st)
{
    int v = pf[st];
    if (v < -14) {
        if ((((-v) & 7) == 0) || (((-v) & 7) == 7)) pf[st] = v + 1;
    } else if (v == 7 || (v & 65534) == 8) {
        if (pf[st-1] >= -2) pf[st] = v + 3;
    }
}

static void band_w3(int16_t *pf, long st)
{
    int v = pf[st];
    if (v < -14) {
        if ((((-v) & 7) == 0) || (((-v) & 7) == 7)) pf[st] = v + 1;
    } else if (v >= 0 && ((v + 2) & 65532) == 8) {
        if (pf[st-1] >= -2) pf[st] = 10;
    } else if (v > 14 && (v & 7) == 7) pf[st] = v + 1;
}

static void lw3(int16_t *pf, int16_t *rf, long cnt, long st, int hi1)
{
    if (hi1) rf[cnt] = 14500;
    else band_w3(pf, st);
}

static void lw5(int16_t *pf, int16_t *rf, long cnt, long st, int res,
                int hi1)
{
    rf[cnt] = 14000;
    if (res == -4) {
        int v = pf[st];
        if (v == -7 || v == -8) {
            if (pf[st-1] > -8 && pf[st-1] < 2) pf[st] = -9;
        }
    } else if (res < -6) {
        if (res < -7 && hi1) rf[cnt] = 14900;
        else {
            int v = pf[st];
            if (v < -14) {
                if ((((-v) & 7) == 0) || (((-v) & 7) == 7)) pf[st] = v + 1;
            } else if (v == 7 || v == 8) {
                if (pf[st-1] >= -1 && pf[st-1] < 8) pf[st] = v + 3;
            }
        }
    }
}

/* rf must be res256 padded with the 1024-short OOB emulation region */
void nhw_column_ladder(int16_t *pf, int16_t *rf, int quality, int low1,
                       int low2, int hi1, int res_setting)
{
    int j, r;
    for (j = 0; j < D; j++) {
        for (r = 0; r < D - 1; r++) {
            long scan = (long)r * N + j;
            long cnt = (long)r * D + j;
            int res = pf[scan] - rf[cnt];
            int a = pf[scan + N] - rf[cnt + D];
            int b2 = pf[scan + 2*N] - rf[cnt + 2*D];
            long st = ((long)j << 9) + r + D;

            if (res == 2 && a == 2 && b2 >= 2) {
                if (b2 < 5 || b2 > 6) {
                    rf[cnt] = 12400; pf[scan+N] -= 2; pf[scan+2*N] -= 2;
                }
            } else if (((res == 2 && a == 3) || (res == 3 && a == 2))
                       && b2 > 1 && b2 < 6) {
                rf[cnt] = 12400; pf[scan+N] -= 2; pf[scan+2*N] -= 2;
            } else if (res == 3 && a == 3) {
                if (b2 > 0 && b2 < 6) {
                    rf[cnt] = 12400; pf[scan+N] -= 2; pf[scan+2*N] -= 2;
                } else if (low1) {
                    rf[cnt] = 12100; pf[scan+N] = rf[cnt+D];
                }
            } else if (a == -4 && (res == 2 || res == 3)
                       && (b2 == 2 || b2 == 3)) {
                if (res == 2 && b2 == 2) pf[scan+N] += 1;
                else {
                    rf[cnt] = 12400; pf[scan+N] -= 2; pf[scan+2*N] -= 2;
                }
            } else if (res == 1 && a == 3 && b2 == 2) {
                if (r > 0 && (pf[scan-N] - rf[cnt-D]) >= 0) {
                    rf[cnt] = 12400; pf[scan+N] -= 2; pf[scan+2*N] -= 2;
                }
            } else if ((res == 3 || res == 4 || res == 5 || res > 6)
                       && (a == 3 || (a & 65534) == 4)) {
                if (res > 6) { rf[cnt] = 12500; pf[scan+N] = rf[cnt+D]; }
                else if (low1) { rf[cnt] = 12100; pf[scan+N] = rf[cnt+D]; }
                else if (low2) {
                    if (res < 5 && a == 5) rf[cnt+D] = 14100;
                    else if (res >= 5) rf[cnt] = 14100;
                    else if (res == 3 && a >= 4) rf[cnt+D] = 14100;
                    pf[scan+N] = rf[cnt+D];
                }
            } else if ((res == 2 || res == 3) && (a == 2 || a == 3)) {
                if (b2 == 0 || b2 == 1) {
                    int d1 = pf[scan+1] - rf[cnt+1];
                    if (d1 == 2 || d1 == 3) {
                        int d2 = pf[scan+N+1] - rf[cnt+D+1];
                        if (d2 == 2 || d2 == 3) {
                            if (pf[scan+2*N+1] - rf[cnt+2*D+1] > 0) {
                                rf[cnt] = 12400;
                                pf[scan+N] -= 2; pf[scan+2*N] -= 2;
                            }
                        }
                    }
                }
            } else if (a == 4 && (res == -2 || res == -3)
                       && (-b2 == 2 || -b2 == 3)) {
                if (res == -2 && b2 == -2) pf[scan+N] -= 1;
                else {
                    rf[cnt] = 12300; pf[scan+N] += 2; pf[scan+2*N] += 2;
                }
            } else if ((res == -3 || res == -4 || res == -5 || res < -7)
                       && (a == -3 || a == -4 || a == -5)) {
                if (res < -7) { rf[cnt] = 12600; pf[scan+N] = rf[cnt+D]; }
                else if (low1) { rf[cnt] = 12200; pf[scan+N] = rf[cnt+D]; }
                else if (low2) {
                    if (res > -5 && a == -5) rf[cnt+D] = 14000;
                    else if (res <= -5) rf[cnt] = 14000;
                    else if (res == -3 && a <= -4) rf[cnt+D] = 14000;
                    pf[scan+N] = rf[cnt+D];
                }
            } else if (a == -2 || a == -3) {
                if (res == -2 || res == -3) {
                    if (-b2 > 0) {
                        rf[cnt] = 12300; pf[scan+N] += 2; pf[scan+2*N] += 2;
                    } else if (res == -3 && hi1) {
                        rf[cnt] = 14500;
                    } else if (-b2 == 0) {
                        int d1 = pf[scan+1] - rf[cnt+1];
                        if (d1 == -2 || d1 == -3) {
                            int d2 = pf[scan+N+1] - rf[cnt+D+1];
                            if (d2 == -2 || d2 == -3) {
                                if (pf[scan+2*N+1] - rf[cnt+2*D+1] < 0) {
                                    rf[cnt] = 12300;
                                    pf[scan+N] += 2; pf[scan+2*N] += 2;
                                }
                            }
                        }
                    } else if (res == -2) band_w2(pf, st);
                    else lw3(pf, rf, cnt, st, hi1);
                } else if (res == -1 && a == -3 && b2 == -2) {
                    if (r > 0 && (pf[scan-N] - rf[cnt-D]) <= 0) {
                        rf[cnt] = 12300; pf[scan+N] += 2; pf[scan+2*N] += 2;
                    }
                } else if (res == -1) {
                    if (-b2 == 3) {
                        rf[cnt] = 12300; pf[scan+N] += 2; pf[scan+2*N] += 2;
                    } else band_w1(pf, st);
                } else if (res == -4) {
                    if (-b2 > 1 && -b2 < 4) {
                        rf[cnt] = 12300; pf[scan+N] += 2; pf[scan+2*N] += 2;
                    } else lw5(pf, rf, cnt, st, res, hi1);
                }
            } else if (res == 0 || res == -1) {
                band_w1(pf, st);
            } else if (res == -2) {
                band_w2(pf, st);
            } else if (res == -3) {
                lw3(pf, rf, cnt, st, hi1);
            } else if (res < -res_setting) {
                lw5(pf, rf, cnt, st, res, hi1);
            }
        }
    }
}

void nhw_classify(int16_t *pf, int16_t *rf, int hi1, int res_setting,
                  long *counts /* n1, n3, n5 */)
{
    long n1 = 0, n3 = 0, n5 = 0;
    int r, j;
    for (r = 0; r < D; r++) {
        for (j = 0; j < D; j++) {
            long scan = (long)r * N + j;
            long cnt = (long)r * D + j;
            int mark = rf[cnt];
            if (mark < 12000) {
                int res = pf[scan] - mark;
                rf[cnt] = 0;
                long st = ((long)j << 9) + r + D;
                if (res == 0 || res == 1) {
                    int v = pf[st];
                    if (v == -7 || v == -8) {
                        if (pf[st-1] > -8 && pf[st-1] < 2) pf[st] = -9;
                    }
                } else if (res == 2) {
                    int v = pf[st];
                    if (v > 15 && !(v & 7)) pf[st] = v - 1;
                    else if (v == -7 || v == -8) {
                        if (pf[st-1] <= 1) pf[st] = -9;
                    } else if (v == -6) {
                        if (pf[st-1] > -8 && pf[st-1] <= -1) pf[st] = -9;
                    }
                } else if (res == 3) {
                    if (hi1) { rf[cnt] = 144; n5++; }
                    else {
                        int v = pf[st];
                        if (v > 15 && !(v & 7)) pf[st] = v - 1;
                        else if (v <= 0 && ((((-v) + 2) & 65532) == 8)) {
                            if (pf[st-1] <= 2) pf[st] = -10;
                        }
                    }
                } else if (res > res_setting) {
                    rf[cnt] = 141; n1++;
                    if (res == 4) {
                        int v = pf[st];
                        if (v == 7 || (v & 65534) == 8) {
                            if (pf[st-1] >= 0 && pf[st-1] < 8)
                                pf[st] = v + 2;
                        }
                    } else if (res > 6) {
                        if (res > 7 && hi1) { rf[cnt] = 148; n5++; n1++; }
                        else {
                            int v = pf[st];
                            if (v > 15 && !(v & 7)) pf[st] = v - 1;
                            else if (v == -6 || v == -7 || v == -8) {
                                if (pf[st-1] > -8 && pf[st-1] < 0)
                                    pf[st] = -9;
                            }
                        }
                    }
                }
            } else {
                int code = 0;
                switch (mark) {
                case 14000: code = 140; n1++; break;
                case 14500: code = 145; n5++; break;
                case 12200: code = 122; n3++; break;
                case 12100: code = 121; n3++; break;
                case 12300: code = 123; n3++; break;
                case 12400: code = 124; n3++; break;
                case 14100: code = 141; n1++; break;
                case 12500: code = 125; n3++; n1++; break;
                case 12600: code = 126; n3++; n1++; break;
                case 14900: code = 149; n5++; n1++; break;
                }
                rf[cnt] = code;
            }
        }
    }
    counts[0] = n1; counts[1] = n3; counts[2] = n5;
}

/* ------------------------------------------------------------------ */
/* requant scan ladder (ops/requant.py requant_scan_ladder); pf is the
 * 512-wide process plane, jf the jpeg plane, rf the 256x256 res256.
 * Both heap shorts just before the C arrays are zero. */

void nhw_scan_ladder(int16_t *jf, int16_t *pf, const int16_t *rf)
{
    long cnt;
    /* baseline: jpeg block = res256 */
    for (cnt = 0; cnt < SZ; cnt++)
        jf[((cnt >> 8) << 9) + (cnt & 255)] = rf[cnt];

    for (cnt = 0; cnt < SZ; cnt++) {
        long e = ((cnt >> 8) << 9) + (cnt & 255);
        int scan = pf[e] - rf[cnt];
        int m;
        if (scan > 11) m = -7;
        else if (scan > 7) m = -4;
        else if (scan > 5) m = -2;
        else if (scan > 4) m = -1;
        else if (scan < -11) m = 7;
        else if (scan < -7) m = 4;
        else if (scan < -5) m = 2;
        else if (scan < -4) m = 1;
        else if (scan > 1 || scan < -1) {
            int a = pf[e + 1] - (cnt + 1 < SZ ? rf[cnt + 1] : 0);
            int left;
            if (a > 4 || a < -4) {
                if (a > 0)
                    a += a > 11 ? -7 : a > 7 ? -4 : a > 5 ? -2 : -1;
                else
                    a += a < -11 ? 7 : a < -7 ? 4 : a < -5 ? 2 : 1;
            }
            left = cnt > 0 ? pf[e - 1] - rf[cnt - 1] : 0;
            a += left;
            if (scan >= 4 && a >= 1) m = -1;
            else if (scan <= -4 && a <= -1) m = 1;
            else if (scan == 3 && a >= 0) m = -1;
            else if (scan == -3 && a <= 0) m = 1;
            else if (a >= 3 || a <= -3) {
                if (scan > 0 && a > 0) m = -1;
                else if (scan < 0 && a < 0) m = 1;
                else if (a >= 5) m = -2;
                else if (a <= -5) m = 2;
                else if (a >= 4) m = -1;
                else if (a <= -4) m = 1;
                else m = 0;
            } else m = 0;
        } else m = 0;

        if (m) {
            jf[e] = (int16_t)(rf[cnt] + m);
            pf[e] = (int16_t)(pf[e] + m);
        }
    }
}

/* ------------------------------------------------------------------ */
/* offsetUV (ops/quantize.py offset_uv); pf padded by 8 shorts         */

void nhw_offset_uv(int16_t *pf, int m2)
{
    long i = 0;
    while (i < SZ) {
        int a = pf[i];
        if (a > 10000) {
            int code = 0;
            switch (a) {
            case 12400: code = 124; break;
            case 12600: code = 126; break;
            case 12900: code = 122; break;
            case 13000: code = 130; break;
            }
            if (code) { pf[i] = code; i++; continue; }
        }
        if (a > 127) {
            int exw = ((a & 0xfff8) - 128) >> 3;
            pf[i] = EXW1[exw > 18 ? 18 : exw];
            i++; continue;
        }
        if (a < -127) {
            int exw = (((-a) & 0xfff8) - 128) >> 3;
            pf[i] = EXW2[exw > 18 ? 18 : exw];
            i++; continue;
        }
        if (a == -7 || a == -8) {
            if ((i & 255) < D - 1 && (pf[i+1] == -7 || pf[i+1] == -8)) {
                pf[i] = 120; pf[i+1] = 120; i += 2; continue;
            }
            a = -a;
            if (pf[i+1] > -8 && pf[i+1] < 0) { if ((a & 7) < 6) a &= 504; }
            else { if ((a & 7) < 7) a &= 504; }
            a = -a;
        } else if (a < 0) {
            a = -a;
            if (pf[i+1] > -8 && pf[i+1] < 0) { if ((a & 7) < 6) a &= 504; }
            else { if ((a & 7) < 7) a &= 504; }
            a = -a;
        } else if (a > 6 && (a & 7) >= 6) {
            if ((i & 255) < D - 1 && pf[i+1] == 7) pf[i+1] = 8;
        }
        if (a < m2 && a > -m2) pf[i] = 128;
        else pf[i] = (a + 128) & 248;
        i++;
    }
}

/* ------------------------------------------------------------------ */
/* select-code promotion + long-run cap (ops/quantize.py)              */

void nhw_select_codes(uint8_t *s, long *sel1_out, long *sel2_out)
{
    long i;
    long sel1 = 0, sel2 = 0;
    for (i = 0; i < 4; i++) s[i] = 128;
    for (i = 4 * SZ - 4; i < 4 * SZ; i++) s[i] = 128;
    for (i = 4; i < 4 * SZ - 4; i++) {
        int v = s[i];
        if (v != 136 && v != 120) continue;
        {
            int nxt = s[i + 1];
            if (s[i+2] == 128 && (nxt == 120 || nxt == 136) && s[i-1] == 128
                && s[i-2] == 128 && s[i-3] == 128 && s[i-4] == 128) {
                s[i+1] = nxt == 120 ? 157 : 159; sel2++;
            } else if (s[i-1] == 128 && (nxt == 120 || nxt == 136)
                       && s[i+2] == 128 && s[i+3] == 128 && s[i+4] == 128
                       && s[i+5] == 128) {
                s[i+1] = nxt == 120 ? 157 : 159; sel2++;
            } else if (s[i-1] == 128 && s[i-2] == 128 && s[i-3] == 128
                       && s[i-4] == 128 && s[i+1] == 128) {
                s[i] = v == 136 ? 153 : 155; sel1++;
            } else if (s[i-1] == 128 && s[i+1] == 128 && s[i+2] == 128
                       && s[i+3] == 128 && s[i+4] == 128) {
                s[i] = v == 136 ? 153 : 155; sel1++;
            }
        }
    }
    *sel1_out = sel1;
    *sel2_out = sel2;
}

static void demote(uint8_t *s, long k)
{
    if (s[k] == 153) s[k] = 124;
    else if (s[k] == 155) s[k] = 123;
}

void nhw_cap_long_runs(uint8_t *s)
{
    long i = 0;
    int count = 0;
    while (i < 4 * SZ) {
        while (s[i] == 128 && s[i + 1] == 128) {
            count += 1;
            if (count > 255) {
                demote(s, i); demote(s, i+1); demote(s, i+2); demote(s, i+3);
                i -= 1; count = 0;
            } else i += 1;
        }
        if (count >= 252) demote(s, i + 1);
        count = 0;
        i += 1;
    }
}

/* ------------------------------------------------------------------ */
/* merge crossing codes (ops/quantize.py merge_crossing_codes)         */

void nhw_merge_crossing(uint8_t *s)
{
    long i = 0;
    long end = 4 * SZ - 4;
    while (i < end) {
        if (s[i] != 128 && s[i+1] == 128) {
            if (s[i+2] == 128) {
                if (s[i+3] == 128) {
                    int v0 = s[i], v4 = s[i+4];
                    if (v0 == 136 && v4 == 136) { s[i]=132; s[i+4]=201; i+=4; }
                    else if (v0 == 136 && v4 == 120) { s[i]=133; s[i+4]=201; i+=4; }
                    else if (v0 == 120 && v4 == 136) { s[i]=134; s[i+4]=201; i+=4; }
                    else if (v0 == 120 && v4 == 120) { s[i]=135; s[i+4]=201; i+=4; }
                    else i += 3;
                } else i += 2;
            } else i += 1;
        }
        i += 1;
    }
}

/* ------------------------------------------------------------------ */
/* Huffman symbol decode (ops/entropy.py)                              */

#define MSW 511
#define ZONE1 110
#define UNZONE1 64
#define WVLT_E 123

/* MSB-first bit i of the packed little-endian u32 code-word stream */
#define GETBIT(w, p) ((int)(((w)[(p) >> 5] >> (31 - ((p) & 31))) & 1u))

/* 16-bit peek LUT over the *static* NHW Huffman tables: entry =
 * (bit_length << 10) | symbol, 0 = unresolvable in 16 bits (the rare
 * 17-20 bit escape ladders, or an invalid prefix) -> bit-serial slow
 * path.  nt1 covers sizes 2-9, nt2 10-14, the zone escape is 15 bits,
 * so everything but the long ladders resolves in one table load.  The
 * tables are fixed by the format (decoder/tables.h:46-189); the build
 * runs once per process, keyed only on first use. */
static uint32_t y_peek_lut[2][65536];
/* combined single+pair entry for the Y decode loop (one load per
 * window): bits 0-9 sym1, 10-14 len1, 15-24 sym2, 25-29 len1+len2
 * (0 = no second code resolves inside the window; whole entry 0 = the
 * first code needs the bit-serial path).  The second lookup during the
 * build is valid because its resolution consumed <= the remaining
 * window bits.  Whether the pair may actually bypass the state machine
 * depends on the per-image vals[] mapping (runs / mem2-setters) — two
 * L1 loads at decode time. */
static uint32_t y_combo_lut[2][65536];
static int y_peek_built = 0;
static pthread_mutex_t y_peek_mu = PTHREAD_MUTEX_INITIALIZER;

static int peek_probe(uint32_t p, int zone_on, const int32_t *nt1,
                      const int32_t *nt2, int *sym)
{
    int tr, size, dec, fail = 0;
/* bit k of the 16-bit prefix; reads past it poison the probe */
#define PBIT(k) ((k) >= 16 ? (fail = 1, 0) : (int)((p >> (15 - (k))) & 1u))
    if (zone_on) {
        int v = 0, k;
        for (k = 0; k < 9; k++) v = (v << 1) | PBIT(k);
        if (v == 0x1) {
            v = 0;
            for (k = 9; k < 15; k++) v = (v << 1) | PBIT(k);
            if (fail) return -1;
            *sym = v + ZONE1;
            return 15;
        }
    }
    tr = 0; size = 0;
    for (;;) {
        tr = (tr << 1) | PBIT(size);
        size += 1;
        if (fail) return -1;
        if (tr == 0x1F) {
            int k;
            tr = 0;
            for (k = 0; k < 5; k++) { tr = (tr << 1) | PBIT(size); size += 1; }
            if (fail) return -1;
            dec = nt2[tr << 4];
            if (dec != 0 && size == (dec >> 9)) break;
            for (;;) {
                tr = (tr << 1) | PBIT(size); size += 1;
                if (fail) return -1;
                if (size == 0xB) {
                    dec = nt2[tr << 3];
                    if (dec != 0 && size == (dec >> 9)) break;
                    if (tr == 0x3 || tr == 0x23) return -1; /* 17-20 bits */
                    continue;
                }
                if (size > 14) return -1;
                dec = nt2[tr << (14 - size)];
                if (dec != 0 && size == (dec >> 9)) break;
            }
            break;
        }
        if (size > 9 || tr > MSW) return -1;
        dec = nt1[tr];
        if (dec != 0 && size == (dec >> 9)) break;
    }
#undef PBIT
    {
        int s2 = dec & MSW;
        if (zone_on && s2 >= ZONE1) s2 += UNZONE1;
        *sym = s2;
    }
    return size;
}

static void nhw_build_y_peek(const int32_t *nt1, const int32_t *nt2)
{
    long p;
    int z;
    if (y_peek_built) return;
    pthread_mutex_lock(&y_peek_mu);
    if (y_peek_built) { pthread_mutex_unlock(&y_peek_mu); return; }
    for (z = 0; z < 2; z++)
        for (p = 0; p < 65536; p++) {
            int sym, len = peek_probe((uint32_t)p, z, nt1, nt2, &sym);
            y_peek_lut[z][p] =
                len > 0 ? (((uint32_t)len << 10) | (uint32_t)sym) : 0;
        }
    for (z = 0; z < 2; z++)
        for (p = 0; p < 65536; p++) {
            uint32_t e1 = y_peek_lut[z][p], e2, l1, l2, c, p2, avail;
            y_combo_lut[z][p] = 0;
            if (!e1) continue;
            l1 = e1 >> 10;
            c = (e1 & 1023) | (l1 << 10);
            p2 = ((uint32_t)p << l1) & 0xFFFF;
            e2 = y_peek_lut[z][p2];
            avail = 16 - l1;
            if (e2) {
                l2 = e2 >> 10;
                /* zone-priority ambiguity: the 15-bit zone escape
                 * overlays the prefix code and wins when the next 9
                 * bits are 000000001 — with fewer than 9 real bits
                 * left, an all-zero remainder cannot rule it out, so
                 * the (possibly very short) tree resolution may be
                 * wrong.  A 1 anywhere in the real remainder kills the
                 * zone prefix and the tree resolution stands. */
                int zone_ambiguous = z && avail < 9
                    && (p2 >> (16 - avail)) == 0;
                if (l1 + l2 <= 16 && !zone_ambiguous)
                    c |= ((e2 & 1023) << 15) | ((l1 + l2) << 25);
            }
            y_combo_lut[z][p] = c;
        }
    y_peek_built = 1;
    pthread_mutex_unlock(&y_peek_mu);
}

static long next_symbol(const uint32_t *words, long pos, int zone_on,
                        const int32_t *nt1, const int32_t *nt2, int *sym,
                        long n_bits)
{
    int tr, size, dec;
    /* max symbol footprint is well under 64 bits; a truncated or corrupt
     * stream fails cleanly instead of reading past the buffer */
    if (pos + 64 > n_bits) return -1;
    {
        long wi = pos >> 5;
        uint64_t win = ((uint64_t)words[wi] << 32) | words[wi + 1];
        uint32_t ent =
            y_peek_lut[zone_on][(win >> (48 - (pos & 31))) & 0xFFFF];
        if (ent) {
            *sym = (int)(ent & 1023);
            return pos + (long)(ent >> 10);
        }
    }
    if (zone_on) {
        int v = 0, k;
        for (k = 0; k < 9; k++) v = (v << 1) | GETBIT(words, pos + k);
        if (v == 0x1) {
            v = 0;
            for (k = 9; k < 15; k++) v = (v << 1) | GETBIT(words, pos + k);
            *sym = v + ZONE1;
            return pos + 15;
        }
    }
    tr = 0; size = 0;
    for (;;) {
        tr = (tr << 1) | GETBIT(words, pos + size);
        size += 1;
        if (tr == 0x1F) {
            int k;
            tr = 0;
            for (k = 0; k < 5; k++) {
                tr = (tr << 1) | GETBIT(words, pos + size); size += 1;
            }
            dec = nt2[tr << 4];
            if (dec != 0 && size == (dec >> 9)) break;
            for (;;) {
                tr = (tr << 1) | GETBIT(words, pos + size); size += 1;
                if (size == 0xB) {
                    dec = nt2[tr << 3];
                    if (dec != 0 && size == (dec >> 9)) break;
                    if (tr == 0x3) {
                        int v = 0;
                        for (k = 0; k < 6; k++) {
                            v = (v << 1) | GETBIT(words, pos + size);
                            size += 1;
                        }
                        dec = v + 110;
                        break;
                    }
                    if (tr == 0x23) {
                        int v = 0;
                        for (k = 0; k < 6; k++) {
                            v = (v << 1) | GETBIT(words, pos + size);
                            size += 1;
                        }
                        if (v < 46) { dec = v + 174; break; }
                        v = (v << 1) | GETBIT(words, pos + size); size += 1;
                        if (v < 104) {
                            dec = (v >> 1) + ((v >> 1) - 46) + (v & 1) + 174;
                            break;
                        }
                        v = (v << 1) | GETBIT(words, pos + size); size += 1;
                        if (v < 246) {
                            dec = 6 + (((v >> 2) - 52) * 3)
                                  + (v >> 2) + (v & 3) + 174;
                            break;
                        }
                        v = (v << 1) | GETBIT(words, pos + size); size += 1;
                        dec = v - 492 + 270;
                        break;
                    }
                    continue;
                }
                if (size > 14) return -1; /* corrupt: no 14-bit match */
                dec = nt2[tr << (14 - size)];
                if (dec != 0 && size == (dec >> 9)) break;
            }
            break;
        }
        if (size > 9 || tr > MSW) return -1; /* corrupt prefix */
        dec = nt1[tr];
        if (dec != 0 && size == (dec >> 9)) break;
    }
    {
        int s2 = dec & MSW;
        if (zone_on && s2 >= ZONE1) s2 += UNZONE1;
        *sym = s2;
    }
    return pos + size;
}

/* one plain (state-free) value symbol: the else-branch of the decode
 * switch minus the mem2-setters 136/120 (the pair fast path below
 * excludes those). */
static inline void emit_plain(int word, int16_t *out, long *e,
                              const int8_t *extra)
{
    switch (word) {
    case 132: out[*e] = 11; out[*e + 4] = 11; *e += 5; return;
    case 133: out[*e] = 11; out[*e + 4] = -11; *e += 5; return;
    case 134: out[*e] = -11; out[*e + 4] = 11; *e += 5; return;
    case 135: out[*e] = -11; out[*e + 4] = -11; *e += 5; return;
    case 127: out[(*e)++] = 1008; return;
    case 129: out[(*e)++] = 1009; return;
    case 125: out[(*e)++] = 1006; return;
    case 126: out[(*e)++] = 1007; return;
    case 121: out[(*e)++] = 1010; return;
    case 122: out[(*e)++] = 1011; return;
    case 124: out[(*e)++] = 11; return;
    case 123: out[(*e)++] = -11; return;
    default:
        if (word < ZONE1 && extra[word]) {
            int x = extra[word];
            out[(*e)++] = x > 0 ? WVLT_E + (x << 3) : (x << 3) - WVLT_E;
        } else if (word > 0x80) {
            out[(*e)++] = (int16_t)(word - 125);
        } else {
            out[(*e)++] = (int16_t)(word - 131);
        }
    }
}

int nhw_decode_y(const uint32_t *words, const int32_t *nt1,
                 const int32_t *nt2, const int32_t *vals,
                 const int32_t *rles, const uint8_t *sel1,
                 const uint8_t *sel2, int zone_on, const int8_t *extra,
                 int16_t *out, long p1, long n_bits, long n_vals,
                 long n_sel1, long n_sel2)
{
    long pos = 0, e = 0;
    int mem = 0, mem2 = 0, nhw_ac1 = 0;
    long run_over = -257;
    long t = 0, t2 = 0;
    int pend_dec = -1;      /* second symbol of a combo entry whose
                             * first needed the state machine */
    long pend_pos = 0;

    nhw_build_y_peek(nt1, nt2);
    for (;;) {
        int dec, word, rle;
        if (e < 0 || e > p1 + 200 || t >= n_sel1 || t2 >= n_sel2)
            return -1;
        if (pend_dec >= 0) {
            dec = pend_dec;
            pos = pend_pos;
            pend_dec = -1;
            goto have_symbol;
        }
        /* one combined-LUT load resolves the next one or two symbols;
         * two plain symbols (no runs, no 136/120 mem2-setters) bypass
         * the state machine entirely */
        if (pos + 64 <= n_bits) {
            long wi = pos >> 5;
            uint64_t win = ((uint64_t)words[wi] << 32) | words[wi + 1];
            uint32_t ce =
                y_combo_lut[zone_on][(win >> (48 - (pos & 31))) & 0xFFFF];
            if (ce) {
                uint32_t plen = ce >> 25;
                if (plen) {
                    int d1 = (int)(ce & 1023), d2 = (int)((ce >> 15) & 1023);
                    if (d1 < n_vals && d2 < n_vals) {
                        int w1 = vals[d1], w2 = vals[d2];
                        if (w1 != 0x80 && w1 != 136 && w1 != 120) {
                            /* first symbol is state-free: emit it and
                             * consume the second from the same entry —
                             * plain ones emit too, runs/specials feed
                             * the state machine without a re-probe */
                            mem = 0; mem2 = 0; nhw_ac1 = 0;
                            emit_plain(w1, out, &e, extra);
                            if (e >= p1 - 1) break;
                            pos += (long)plen;
                            if (w2 != 0x80 && w2 != 136 && w2 != 120) {
                                emit_plain(w2, out, &e, extra);
                                if (e >= p1 - 1) break;
                                continue;
                            }
                            dec = d2;
                            goto have_symbol;
                        }
                    }
                }
                dec = (int)(ce & 1023);
                if (ce >> 25) {
                    int d2 = (int)((ce >> 15) & 1023);
                    if (d2 < n_vals) {
                        pend_dec = d2;
                        pend_pos = pos + (long)(ce >> 25);
                    }
                }
                pos += (long)((ce >> 10) & 31);
                if (dec >= n_vals) return -1;
                goto have_symbol;
            }
        }
        pos = next_symbol(words, pos, zone_on, nt1, nt2, &dec, n_bits);
        if (pos < 0 || dec < 0 || dec >= n_vals) return -1;
have_symbol:
        word = vals[dec];
        rle = rles[dec];

        if (word == 0x80) {
            mem += 1;
            if (mem2 == 1) {
                if (e >= 5 && !(out[e-2] || out[e-3] || out[e-4]
                                || out[e-5])) {
                    out[e] = sel2[t2] ? 11 : -11; t2++; e++;
                } else if (rle >= 4 && e >= 2 && !out[e-2]) {
                    out[e] = sel2[t2] ? 11 : -11; t2++; e++;
                }
                mem2 = 0;
            } else if (mem == 2 && !nhw_ac1) {
                if (e >= 4 && !(out[e-1] || out[e-2] || out[e-3]
                                || out[e-4])
                    && (e + rle - 257) >= run_over) {
                    out[e] = sel1[t] ? -11 : 11; t++; e++; mem = 1;
                } else if (rle >= 4 && e > 0 && !out[e-1]
                           && (e + rle - 257) >= run_over) {
                    out[e] = sel1[t] ? -11 : 11; t++; e++; mem = 1;
                }
            } else if (rle >= 4 && e > 0 && !out[e-1] && !nhw_ac1
                       && (e + rle - 257) >= run_over) {
                out[e] = sel1[t] ? -11 : 11; t++; e++; mem = 1;
            }
            if (rle == 254) { nhw_ac1 = 1; mem = 0; run_over = e; }
            else nhw_ac1 = 0;
            e += rle;
        } else {
            mem = 0; mem2 = 0; nhw_ac1 = 0;
            switch (word) {
            case 136: out[e] = 11; e++; mem2 = 1; break;
            case 120: out[e] = -11; e++; mem2 = 1; break;
            case 132: out[e] = 11; out[e+4] = 11; e += 5; break;
            case 133: out[e] = 11; out[e+4] = -11; e += 5; break;
            case 134: out[e] = -11; out[e+4] = 11; e += 5; break;
            case 135: out[e] = -11; out[e+4] = -11; e += 5; break;
            case 127: out[e] = 1008; e++; break;
            case 129: out[e] = 1009; e++; break;
            case 125: out[e] = 1006; e++; break;
            case 126: out[e] = 1007; e++; break;
            case 121: out[e] = 1010; e++; break;
            case 122: out[e] = 1011; e++; break;
            case 124: out[e] = 11; e++; break;
            case 123: out[e] = -11; e++; break;
            default:
                if (word < ZONE1 && extra[word]) {
                    int x = extra[word];
                    out[e] = x > 0 ? WVLT_E + (x << 3) : (x << 3) - WVLT_E;
                    e++;
                } else if (word > 0x80) {
                    out[e] = word - 125; e++;
                } else {
                    out[e] = word - 131; e++;
                }
            }
        }
        if (e >= p1 - 1) break;
    }
    return 0;
}

/* one UV symbol's whole effect — the UV automaton is stateless
 * (decoder/compress_pixel.c:446-641), so any two symbols resolved from
 * one window can apply back to back */
static inline long uv_emit(int word, long rle, int16_t *out, long e,
                           const int8_t *extra)
{
    if (word == 0x80) return e + rle;
    if (word < ZONE1) {
        int x = extra[word];
        if (x) out[e] = x > 0 ? WVLT_E + (x << 3) : (x << 3) - WVLT_E;
        else out[e] = (int16_t)(word - 131);
    } else if (word == 124) out[e] = 5005;
    else if (word == 126) out[e] = 5006;
    else if (word == 122) out[e] = 5003;
    else if (word == 130) out[e] = 5004;
    else if (word > 0x80) out[e] = (int16_t)(word - 125);
    else out[e] = (int16_t)(word - 131);
    return e + 1;
}

int nhw_decode_uv(const uint32_t *words, const int32_t *nt1,
                  const int32_t *nt2, const int32_t *vals,
                  const int32_t *rles, const int8_t *extra,
                  int16_t *out, long p1, long n_bits, long n_vals)
{
    long pos = 0, e = 0;
    nhw_build_y_peek(nt1, nt2);
    for (;;) {
        int dec;
        if (e < 0 || e > p1 + 200) return -1;
        if (pos + 64 <= n_bits) {
            long wi = pos >> 5;
            uint64_t win = ((uint64_t)words[wi] << 32) | words[wi + 1];
            uint32_t ce =
                y_combo_lut[0][(win >> (48 - (pos & 31))) & 0xFFFF];
            if (ce) {
                dec = (int)(ce & 1023);
                if (dec >= n_vals) return -1;
                if (ce >> 25) {
                    int d2 = (int)((ce >> 15) & 1023);
                    if (d2 < n_vals) {
                        pos += (long)(ce >> 25);
                        e = uv_emit(vals[dec], rles[dec], out, e, extra);
                        if (e >= p1 - 1) break;
                        e = uv_emit(vals[d2], rles[d2], out, e, extra);
                        if (e >= p1 - 1) break;
                        continue;
                    }
                }
                pos += (long)((ce >> 10) & 31);
                goto got;
            }
        }
        pos = next_symbol(words, pos, 0, nt1, nt2, &dec, n_bits);
        if (pos < 0 || dec < 0 || dec >= n_vals) return -1;
got:
        e = uv_emit(vals[dec], rles[dec], out, e, extra);
        if (e >= p1 - 1) break;
    }
    return 0;
}

/* ------------------------------------------------------------------ */
/* pre-filter kernel pass + q>LOW4 pair walk (ops/prefilter.py)        */

/* chroma bilinear x2 upsample, vertical then horizontal with the
   (a+b+1)>>1 rounding of decoder/nhw_decoder.c:1137-1181; input is the
   clipped 0..255 int16 (256,256) plane, output the (512,512) u8 plane */
void nhw_upsample2x(const int16_t *p, uint8_t *out)
{
    uint8_t v[512 * 256];
    int r, c;
    for (r = 0; r < 255; r++) {
        const int16_t *a = p + r * 256, *b = a + 256;
        uint8_t *e = v + (long)2 * r * 256, *o = e + 256;
        for (c = 0; c < 256; c++) {
            e[c] = (uint8_t)a[c];
            o[c] = (uint8_t)((a[c] + b[c] + 1) >> 1);
        }
    }
    for (c = 0; c < 256; c++) {
        uint8_t t = (uint8_t)p[255 * 256 + c];
        v[510 * 256 + c] = t;
        v[511 * 256 + c] = t;
    }
    for (r = 0; r < 512; r++) {
        const uint8_t *row = v + (long)r * 256;
        uint8_t *orow = out + (long)r * 512;
        for (c = 0; c < 255; c++) {
            orow[2 * c] = row[c];
            orow[2 * c + 1] = (uint8_t)((row[c] + row[c + 1] + 1) >> 1);
        }
        orow[510] = row[255];
        orow[511] = row[255];
    }
}

/* 8-neighbour gradient sums over the interior (signed sum + abs sum),
   matching ops/prefilter._gradient_sums (image_processing.c:605-618).
   res/cnt must arrive zeroed (the border rows/cols stay 0). */
void nhw_gradient_sums(const int16_t *p, int32_t *res, int32_t *cnt)
{
    int r, j;
    for (r = 1; r < N - 1; r++) {
        const int16_t *row = p + (long)r * N;
        int32_t *rs = res + (long)r * N;
        int32_t *cs = cnt + (long)r * N;
        for (j = 1; j < N - 1; j++) {
            int c = row[j];
            int d0 = c - row[j - 1],     d1 = c - row[j + 1];
            int d2 = c - row[j - N],     d3 = c - row[j + N];
            int d4 = c - row[j - N + 1], d5 = c - row[j - N - 1];
            int d6 = c - row[j + N - 1], d7 = c - row[j + N + 1];
            rs[j] = d0 + d1 + d2 + d3 + d4 + d5 + d6 + d7;
            cs[j] = (d0 < 0 ? -d0 : d0) + (d1 < 0 ? -d1 : d1)
                  + (d2 < 0 ? -d2 : d2) + (d3 < 0 ? -d3 : d3)
                  + (d4 < 0 ? -d4 : d4) + (d5 < 0 ? -d5 : d5)
                  + (d6 < 0 ? -d6 : d6) + (d7 < 0 ? -d7 : d7);
        }
    }
}

/* gradient sums fused with the q>LOW4 kernel automaton: one pass over
   the luma plane, no res/cnt materialization (the res4 accumulator walks
   the same raster order the sums are produced in). */
void nhw_kernel_simple_fused(const int16_t *p, int32_t *out)
{
    /* stencil split from the res4 feedback chain: the per-pixel
     * gradient sums vectorize, the chain runs branchless (the original
     * content-dependent branches mispredict on texture) */
    int r, j;
    int res4 = 0;
    int32_t v[512], a[512];
    for (r = 1; r < N - 1; r++) {
        const int16_t *row = p + (long)r * N;
        int32_t *os = out + (long)r * N;
        for (j = 1; j < N - 1; j++) {
            int c = row[j];
            int d0 = c - row[j - 1],     d1 = c - row[j + 1];
            int d2 = c - row[j - N],     d3 = c - row[j + N];
            int d4 = c - row[j - N + 1], d5 = c - row[j - N - 1];
            int d6 = c - row[j + N - 1], d7 = c - row[j + N + 1];
            v[j] = d0 + d1 + d2 + d3 + d4 + d5 + d6 + d7;
            a[j] = (d0 < 0 ? -d0 : d0) + (d1 < 0 ? -d1 : d1)
                 + (d2 < 0 ? -d2 : d2) + (d3 < 0 ? -d3 : d3)
                 + (d4 < 0 ? -d4 : d4) + (d5 < 0 ? -d5 : d5)
                 + (d6 < 0 ? -d6 : d6) + (d7 < 0 ? -d7 : d7);
        }
        for (j = 1; j < N - 1; j++) {
            int vv = v[j];
            int av = vv < 0 ? -vv : vv;
            int nr = 15 * av + a[j] + ((res4 + 2) >> 2);
            int o = nr >> 4;
            os[j] = vv == 0 ? 0 : (vv < 0 ? -o : o);
            res4 = vv == 0 ? 0 : (nr & 15);
        }
    }
}

void nhw_kernel_simple(const int32_t *res, const int32_t *cnt, int32_t *out)
{
    int r, j;
    int res4 = 0;
    for (r = 1; r < 511; r++) {
        long base = (long)r * N;
        for (j = 1; j < 511; j++) {
            long scan = base + j;
            int v = res[scan];
            if (v < 0) {
                res4 = 15 * (-v) + cnt[scan] + ((res4 + 2) >> 2);
                out[scan] = -(res4 >> 4);
                res4 &= 15;
            } else if (v > 0) {
                res4 = 15 * v + cnt[scan] + ((res4 + 2) >> 2);
                out[scan] = res4 >> 4;
                res4 &= 15;
            } else {
                out[scan] = 0;
                res4 = 0;
            }
        }
    }
}

void nhw_pair_walk_simple(int16_t *jf, const int32_t *kf)
{
    int r;
    int a = 0;
    for (r = 1; r < 511; r++) {
        long base = (long)r * N;
        long j = 1;
        while (j < 510) {
            long s0 = base + j, s1 = base + j + 1;
            int res = kf[s0], count = kf[s1];
            int e;

            if (res > 201) { jf[s0] -= 2; e = 4; }
            else if (res < -201) { jf[s0] += 2; e = 3; }
            else if (res > 176) { jf[s0] -= 1; e = 2; }
            else if (res < -176) { jf[s0] += 1; e = 1; }
            else e = 0;
            if (count > 201) {
                if (e == 0 || e == 3) jf[s1] -= 2;
                else if (e != 4) jf[s1] -= 1;
            } else if (count < -201) {
                if (e == 0 || e == 4) jf[s1] += 2;
                else if (e != 3) jf[s1] += 1;
            } else if (count > 176) {
                if (e != 4) jf[s1] -= 1;
            } else if (count < -176) {
                if (e != 3) jf[s1] += 1;
            }

            if (res > 10 && res < 32) {
                if (count >= 23 || count <= -23) {
                    if (res < 16) {
                        if (count > 0 && count < 32 && res > 11) jf[s1] += 1;
                        jf[s0] += 1;
                        a = 0; j += 2; continue;
                    } else {
                        jf[s0] += a ? 1 : 2;
                        a = 0; j += 2; continue;
                    }
                }
            } else if (res > -32 && res < -10) {
                if (count >= 23 || count <= -23) {
                    if (res > -16) {
                        if (count > -32 && count < 0 && res < -11)
                            jf[s1] -= 1;
                        jf[s0] -= 1;
                        a = 0; j += 2; continue;
                    } else {
                        jf[s0] -= a ? 1 : 2;
                        a = 0; j += 2; continue;
                    }
                }
            }
            a = 0;
            if (count > 10 && count < 32) {
                if (res >= 23 || res <= -23) {
                    if (count < 16) {
                        if (res > 0 && res < 32 && count > 11) jf[s0] += 1;
                        jf[s1] += 1;
                    } else { jf[s1] += 2; a = 1; }
                }
            } else if (count > -32 && count < -10) {
                if (res >= 23 || res <= -23) {
                    if (count > -16) {
                        if (res > -32 && res < 0 && count < -11) jf[s0] -= 1;
                        jf[s1] -= 1;
                    } else { jf[s1] -= 2; a = 1; }
                }
            }
            j += 2;
        }
    }
}

/* ------------------------------------------------------------------ */
/* offsetY_recons256 band quantizer (ops/requant.py _quantize_band)    */

void nhw_quantize_band(int16_t *jf, int16_t *pf, int low4, int m1, int part,
                       int r0, int r1_, int c0, int c1)
{
    int r;
    for (r = r0; r < r1_; r++) {
        long base = (long)r * N;
        int quant = 0, quant6 = 0;
        long j = c0;
        while (j < c1) {
            int a = pf[base + j];
            if (a > 15000) {
                switch (a) {
                case 15300: jf[base + j] = 5; j += 3; break;
                case 15400: jf[base + j] = -5; j += 3; break;
                case 15500: jf[base + j] = 5; j += 2; break;
                case 15600: jf[base + j] = -5; j += 2; break;
                case 15700: jf[base + j] = 6; jf[base + j + 1] = 6;
                            j += 2; break;
                case 15800: jf[base + j] = -6; jf[base + j + 1] = -6;
                            j += 2; break;
                default: j += 1;
                }
                continue;
            }
            if (a < -12 && (((-a) & 7) == 6)) {
                if (j < 255 && pf[base + j + 1] == -7) pf[base + j + 1] = -8;
            }
            if (a < 0) {
                if (a == -7 && j < 255 && pf[base + j + 1] == 8) {
                    pf[base + j] = -8; a = -8;
                }
                a = -a;
                if (low4) {
                    if (a == 15) {
                        if (!quant) { a &= 65528; quant = 1; }
                        else quant = (quant + 1) % 6;
                    } else if (a > 22 && (a & 7) == 7) {
                        if (!quant6) { a &= 65528; quant6 = 1; }
                        else quant6 = (quant6 + 1) % 4;
                    } else a &= 65528;
                } else {
                    if ((a & 7) < 7) a &= 65528;
                }
                a = -a;
            } else if (a == 8 && j < 255 && pf[base + j + 1] == -7) {
                pf[base + j + 1] = -8;
            } else if (a > 12 && !part && (a & 7) >= 6) {
                if (j < 255 && pf[base + j + 1] == 7) pf[base + j + 1] = 8;
            }
            if (a < m1 && a > -m1) { jf[base + j] = 0; j += 1; continue; }
            a += 128;
            if (a < 0) a = -((-a) & 65528);
            else a &= 65528;
            jf[base + j] = (int16_t)(a > 128 ? a - 125 : a - 131);
            j += 1;
        }
    }
}

/* ------------------------------------------------------------------ */
/* q<=LOW4 pre-filter: kernel sentinels + t1..t44 pair walk + epilogues
 * (ops/prefilter.py _kernel_pass_low4 / _pair_walk_low /
 *  _sentinel_pass_low4 / _pair_sharpen_low4)                          */

void nhw_kernel_low4(const int32_t *res, const int32_t *cnt, int32_t *out,
                     int sharpness, int sharpn2)
{
    int r, j;
    int res4 = 0, res3 = 0, a = 0;
    int t1 = 0, t2 = 0, t4 = 0, t5 = 0, t6 = 0, t7 = 0;
    for (r = 1; r < 511; r++) {
        long base = (long)r * N;
        for (j = 1; j < 511; j++) {
            long scan = base + j;
            int v = res[scan];
            if (v < 0) {
                int res2;
                res4 = 15 * (-v) + cnt[scan] + ((res4 + 2) >> 2);
                res2 = -(res4 >> 4);
                res4 &= 15;
                if (res2 == -sharpn2) {
                    if (t7 < 3) { res2 = -sharpn2 - 1; t7++; }
                }
                if (-v <= sharpn2 && (res2 < -sharpn2 || res2 > sharpn2)
                    && res2 >= -(sharpn2 + 20) && res2 <= sharpn2 + 20) {
                    int k0 = out[scan - 1];
                    if (j > 1 && (k0 < 0 ? -k0 : k0) <= (sharpness >> 1))
                        res3 = 0;
                    if (!res3) { out[scan] = -20000; res3 = 1; }
                    else {
                        out[scan] = res2;
                        if (!t1) { res3 = 0; t1 = 1; }
                        else {
                            if (res3 == 1) res3 = 2;
                            else {
                                res3 = 0;
                                if (t1 == 1) t1 = 2;
                                else if (t1 == 2) t1 = 3;
                                else t1 = 0;
                            }
                        }
                    }
                } else out[scan] = res2;
            } else if (v > 0) {
                int res2;
                res4 = 15 * v + cnt[scan] + ((res4 + 2) >> 2);
                res2 = res4 >> 4;
                res4 &= 15;
                if (v <= sharpn2 && res2 > sharpn2
                    && res2 <= sharpn2 + 20) {
                    int k0 = out[scan - 1];
                    int ak0 = k0 < 0 ? -k0 : k0;
                    if (j > 1 && ak0 <= (sharpness >> 1)) a = 0;
                    else if (j > 1 && (ak0 > 10000 || k0 == sharpn2 + 21)) {
                        if (!t4) { a = 0; if (!t2) t2 = 1; t4 = 1; }
                        else t4 = 0;
                    } else if (j > 1 && k0 == -(sharpn2 + 21)) {
                        if (!t5) t5 = 1;
                        else {
                            if (!t4) { a = 0; if (!t2) t2 = 1; t4 = 1; }
                            else t4 = 0;
                            if (t5 == 1) t5 = 2; else t5 = 0;
                        }
                    } else if (j > 1 && k0 == sharpn2 + 22) {
                        out[scan - 1] = 7000;
                    }
                    if (!a) { out[scan] = 20000; a = 1; }
                    else {
                        out[scan] = res2;
                        if (!t2) { a = 0; t2 = 1; }
                        else {
                            if (a == 1) a = 2;
                            else {
                                a = 0;
                                if (t2 == 1) t2 = 2;
                                else if (t2 == 2) t2 = 3;
                                else t2 = 0;
                            }
                        }
                    }
                } else if (res2 == sharpn2 + 21) {
                    if (!t6) out[scan] = 7000; else out[scan] = res2;
                    t6++;
                } else out[scan] = res2;
            } else {
                out[scan] = 0;
                res4 = 0;
            }
        }
    }
}

void nhw_sentinel_pass_low4(int16_t *jf, int32_t *kf, uint8_t *sharp,
                            int sharpness, int sharpn2)
{
    int t1 = 0, t2 = 0, t3 = 0, t4 = 0, t5 = 0, t6 = 0;
    int r;
    for (r = 1; r < 511; r++) {
        long base = (long)r * N;
        long j = 1;
        int e = 0, t = 0, f = 0;
        while (j < 509) {
            long s0 = base + j, s1 = base + j + 1;
            int res = kf[s0], count = kf[s1];
            int ares = res < 0 ? -res : res;
            int acount = count < 0 ? -count : count;

            if (ares > 6000) {
                if (res == 20000) {
                    if (!t3) { kf[s0] = 0; t3 = 1; }
                    else { kf[s0] = 5000; t3 = (t3 == 1) ? 2 : 0; }
                } else if (res == -20000) {
                    if (!t4) { kf[s0] = 0; t4 = 1; }
                    else { kf[s0] = -5000; t4 = (t4 == 1) ? 2 : 0; }
                } else if (res == 7000) kf[s0] = sharpn2 + 22;
                if (!t2) {
                    if (count == 20000) {
                        if (!t5) { kf[s1] = 0; t5 = 1; }
                        else { kf[s1] = 5000; t5 = (t5 == 1) ? 2 : 0; }
                    } else if (count == -20000) {
                        if (!t6) { kf[s1] = 0; t6 = 1; }
                        else { kf[s1] = -5000; t6 = (t6 == 1) ? 2 : 0; }
                    } else if (count == 7000) kf[s1] = sharpn2 + 22;
                    t2 = 1;
                } else t2 = 0;
                if (!t1) { t1 = 1; j += 2; continue; }
                t1 = 0;
                /* fall through into the sharpening with the sentinel res */
            } else if (acount > 6000) {
                if (count == 20000) {
                    if (!t5) { kf[s1] = 0; t5 = 1; }
                    else { kf[s1] = 5000; t5 = (t5 == 1) ? 2 : 0; }
                } else if (count == -20000) {
                    if (!t6) { kf[s1] = 0; t6 = 1; }
                    else { kf[s1] = -5000; t6 = (t6 == 1) ? 2 : 0; }
                } else if (count == 7000) kf[s1] = sharpn2 + 22;
                j += 2;
                continue;
            }

            ares = res < 0 ? -res : res;
            acount = count < 0 ? -count : count;
            if (ares > sharpness + 20 && acount > (sharpness >> 1)
                && acount <= sharpn2) {
                if (res > 0) {
                    jf[s0] += 1; sharp[s0] = 1;
                    if (count > 0) { jf[s1] += 2; sharp[s1] = 1; }
                    if (s1 >= 2 * N + 2) {
                        long sc = s1 - N;
                        int r2 = kf[sc];
                        if (r2 > 4) { jf[sc] += 1; sharp[sc] = 1; }
                        sc -= 1;
                        {
                            int r3 = kf[sc];
                            if (r3 > 4) { jf[sc] += 1; sharp[sc] = 1; }
                            if (r2 < -24 && !t) { jf[sc+1] -= 1; sharp[sc+1] = 1; }
                            if (r3 < -24 && !t) { jf[sc] -= 1; sharp[sc] = 1; }
                        }
                    }
                    e = 0; f = 0;
                } else if (res < 0) {
                    jf[s0] -= 1; sharp[s0] = 1;
                    if (count < 0) { jf[s1] -= 2; sharp[s1] = 1; }
                    if (s1 >= 2 * N + 2) {
                        long sc = s1 - N;
                        int r2 = kf[sc];
                        if (r2 < -4) { jf[sc] -= 1; sharp[sc] = 1; }
                        sc -= 1;
                        {
                            int r3 = kf[sc];
                            if (r3 < -4) { jf[sc] -= 1; sharp[sc] = 1; }
                            if (r2 > 24 && !t) { jf[sc+1] += 1; sharp[sc+1] = 1; }
                            if (r3 > 24 && !t) { jf[sc] += 1; sharp[sc] = 1; }
                        }
                    }
                    e = 0; f = 0;
                }
                if (t == 1) { j += 1; t = 0; }
                else if (t == 2) { j += 3; t = 0; }
                j += 2;
            } else if (acount > sharpness + 20 && ares > (sharpness >> 1)
                       && ares <= sharpn2) {
                if (count > 0) {
                    jf[s1] += 1; sharp[s1] = 1;
                    if (res > 0) { jf[s0] += 2; sharp[s0] = 1; }
                    if (s1 >= 2 * N + 2) {
                        long sc = s1 - (N + 1);
                        int r2 = kf[sc];
                        if (r2 > 4) { jf[sc] += 1; sharp[sc] = 1; }
                        sc += 1;
                        {
                            int r3 = kf[sc];
                            if (r3 > 4) { jf[sc] += 1; sharp[sc] = 1; }
                            if (r2 < -24 && !t) { jf[sc-1] -= 1; sharp[sc-1] = 1; }
                            if (r3 < -24 && !t) { jf[sc] -= 1; sharp[sc] = 1; }
                        }
                    }
                    e = 0; f = 0;
                } else if (count < 0) {
                    jf[s1] -= 1; sharp[s1] = 1;
                    if (res < 0) { jf[s0] -= 2; sharp[s0] = 1; }
                    if (s1 >= 2 * N + 2) {
                        long sc = s1 - (N + 1);
                        int r2 = kf[sc];
                        if (r2 < -4) { jf[sc] -= 1; sharp[sc] = 1; }
                        sc += 1;
                        {
                            int r3 = kf[sc];
                            if (r3 < -4) { jf[sc] -= 1; sharp[sc] = 1; }
                            if (r2 > 24 && !t) { jf[sc-1] += 1; sharp[sc-1] = 1; }
                            if (r3 > 24 && !t) { jf[sc] += 1; sharp[sc] = 1; }
                        }
                    }
                    e = 0; f = 0;
                }
                if (t == 1) { j += 1; t = 0; }
                else if (t == 2) { j += 3; t = 0; }
                j += 2;
            } else {
                e += 1;
                if (!t) f += 1;
                if (e == 2) { j -= 3; e = 0; t = 1; }
                else if (t == 1) {
                    j += 1; t = 0; e = 0;
                    if (f == 4) {
                        int c1 = kf[base + j + 1 - 5];
                        int c2 = kf[base + j + 1 - 2];
                        if ((c1 < 0 ? -c1 : c1) <= sharpn2
                            || (c2 < 0 ? -c2 : c2) <= sharpn2) {
                            j -= 5; t = 2;
                        }
                        f = 0;
                    }
                } else if (t == 2) { j += 3; t = 0; e = 0; f = 0; }
                j += 2;
            }
        }
    }
}

void nhw_pair_sharpen_low4(int16_t *jf, const int32_t *kf,
                           const uint8_t *sharp, int sharpness, int sharpn2)
{
    int r;
    for (r = 1; r < 511; r++) {
        long base = (long)r * N;
        long j = 1;
        while (j < 510) {
            long s0 = base + j, s1 = base + j + 1;
            int res = kf[s0], count = kf[s1];
            int ares = res < 0 ? -res : res;
            int acount = count < 0 ? -count : count;

            if (ares > 4000 || acount > 4000) { j += 2; continue; }

            if (ares > sharpness && ares <= sharpness + 20
                && acount > sharpness && acount <= sharpness + 20) {
                if (sharp[s0] != 1 && sharp[s1] != 1) {
                    if (res > 0 && count > 0) {
                        if (res >= count) {
                            if (sharp[s0] != 2) jf[s0] += 1;
                            else if (sharp[s1] != 2) jf[s1] += 1;
                        } else {
                            if (sharp[s1] != 2) jf[s1] += 1;
                            else if (sharp[s0] != 2) jf[s0] += 1;
                        }
                    } else if (res < 0 && count < 0) {
                        if (res <= count) {
                            if (sharp[s0] != 3) jf[s0] -= 1;
                            else if (sharp[s1] != 3) jf[s1] -= 1;
                        } else {
                            if (sharp[s1] != 3) jf[s1] -= 1;
                            else if (sharp[s0] != 3) jf[s0] -= 1;
                        }
                    } else if (j < 507) {
                        int k1 = kf[s1 + 1];
                        int ak1 = k1 < 0 ? -k1 : k1;
                        if (ak1 > sharpness && ak1 <= sharpness + 20) {
                            if ((count > 0 && k1 > 0)
                                || (count < 0 && k1 < 0)) j -= 1;
                        }
                    }
                } else if (j < 507) {
                    int k1 = kf[s1 + 1];
                    int ak1 = k1 < 0 ? -k1 : k1;
                    if (ak1 > sharpness && ak1 <= sharpness + 20) {
                        if ((count > 0 && k1 > 0)
                            || (count < 0 && k1 < 0)) j -= 1;
                    }
                }
            } else if (ares > sharpness + 56 && acount > sharpness + 56) {
                if (!sharp[s0] && !sharp[s1]) {
                    if (res > 0 && count < 0) { jf[s0] += 1; jf[s1] -= 1; }
                    else if (res < 0 && count > 0) { jf[s0] -= 1; jf[s1] += 1; }
                    else if (ares > sharpness + 96 && acount > sharpness + 96) {
                        if (res > 0 && count > 0) {
                            if (res > count) jf[s0] += 1; else jf[s1] += 1;
                        } else if (res < 0 && count < 0) {
                            if (res < count) jf[s0] -= 1; else jf[s1] -= 1;
                        }
                    }
                }
            } else if (ares > sharpness + 160 && acount > sharpn2
                       && acount <= sharpn2 + 20) {
                if (!sharp[s0] && !sharp[s1]) {
                    if (res > 0 && count > 0) jf[s1] -= 1;
                    else if (res < 0 && count < 0) jf[s1] += 1;
                    else if (j < 505) {
                        int k1 = kf[s1+1], k2 = kf[s1+2];
                        int ak1 = k1 < 0 ? -k1 : k1;
                        int ak2 = k2 < 0 ? -k2 : k2;
                        if (ak1 > sharpness + 160 && ak2 <= sharpn2) j -= 1;
                    }
                } else if (j < 505) {
                    int k1 = kf[s1+1], k2 = kf[s1+2];
                    int ak1 = k1 < 0 ? -k1 : k1;
                    int ak2 = k2 < 0 ? -k2 : k2;
                    if (ak1 > sharpness + 160 && ak2 > sharpn2 + 20) j -= 1;
                }
            } else if (acount > sharpness + 160 && ares > sharpn2
                       && ares <= sharpn2 + 20) {
                if (!sharp[s0] && !sharp[s1]) {
                    if (res > 0 && count > 0) jf[s0] -= 1;
                    else if (res < 0 && count < 0) jf[s0] += 1;
                    else if (j < 507) {
                        int k1 = kf[s1+1];
                        int ak1 = k1 < 0 ? -k1 : k1;
                        if (ak1 > sharpn2 && ak1 <= sharpn2 + 20) j -= 1;
                    }
                } else j -= 1;
            } else j -= 1;
            j += 2;
        }
    }
}

/* the q<=LOW4 t1..t44 pair-walk automaton (ops/prefilter._pair_walk_low) */

static int iabs(int v) { return v < 0 ? -v : v; }

void nhw_pair_walk_low(int16_t *jf, const int16_t *pf, int32_t *kf,
                       uint8_t *sharp_on, int low_on, int ladder_on,
                       int sharpness, int sharpn2, int n1)
{
    int a = 0;
    int t1=0,t2=0,t3=0,t4=0,t5=0,t6=8,t7=0,t8=0,t9=0,t10=10,t11=15;
    int t12=0,t13=0,t14=0,t15=0,t16=0,t17=0,t18=8,t19=0,t20=0;
    int t21=0,t22=0,t23=0,t24=0,t25=0,t26=0,t27=0,t28=0,t29=0;
    int t30=0,t31=0,t32=0,t33=0,t34=0,t35=0,t36=0,t37=0,t38=0;
    int t39=0,t40=0,t41=0,t42=0,t43=0,t44=2;
    int w1=0,w2=0,w3=20,w4=0,w5=0,w6=0,w7=0,w8=0;
    int r;

    for (r = 1; r < 511; r++) {
        long base = (long)r * N;
        long i_flat = base;
        long j = 1;
        while (j < 510) {
            long s0 = base + j, s1 = base + j + 1;
            int res = kf[s0], count = kf[s1];

            if (low_on) {
                if (iabs(res) > 4 && iabs(res) < n1) {
                    long sc = s0;
                    if (iabs(pf[sc-N]-pf[sc-1]) < 4
                        && iabs(pf[sc-1]-pf[sc+N]) < 4
                        && iabs(pf[sc+N]-pf[sc+1]) < 4
                        && iabs(pf[sc+1]-pf[sc-N]) < 4) {
                        jf[sc] = (int16_t)(((pf[sc] << 2) + pf[sc-1]
                                  + pf[sc+1] + pf[sc-N] + pf[sc+N] + 4)
                                 >> 3);
                    }
                }
                if (iabs(count) > 4 && iabs(count) < n1) {
                    long sc = s1;
                    if (iabs(pf[sc-N]-pf[sc-1]) < 4
                        && iabs(pf[sc-1]-pf[sc+N]) < 4
                        && iabs(pf[sc+N]-pf[sc+1]) < 4
                        && iabs(pf[sc+1]-pf[sc-N]) < 4) {
                        jf[sc] = (int16_t)(((pf[sc] << 2) + pf[sc-1]
                                  + pf[sc+1] + pf[sc-N] + pf[sc+N] + 4)
                                 >> 3);
                    }
                }
            }

            if (!t1) {
                t2 = 0;
                if (iabs(res) > sharpness) {
                    if (res > 0) jf[s0] += 2; else jf[s0] -= 2;
                    if (iabs(count) > sharpn2 || t8 == 1) {
                        kf[s0] = 0;
                        if ((t19 < 4*SZ || (t20 >= 3 && t20 < 4*SZ))
                            && iabs(res) > sharpness + 96 && t6 > 0
                            && i_flat > 2 * N) {
                            if (t20 >= 3 && t19 >= 8*SZ) {
                                t6 = 7000000; t20 = 8*SZ;
                            }
                            if (t19 > 0 && t19 < 4*SZ) {
                                if (t20 > 2 || (t20 == 2 && t6 > 3 && !t23)
                                    || (t20 == 2 && t6 > 14 && t23 > 0)) {
                                    if (t23 == 1) t6 = 5000000;
                                    t23 += 1;
                                    t21 += 1;
                                    if (t21 >= 2) t19 = 8*SZ;
                                }
                            }
                            if (!t19) { t6 += 1; t20 = 1; }
                            t19 += 1;
                        }
                    }
                    t2 = 1;
                }
                if (iabs(count) > sharpness) {
                    if ((t2 == 1 || t12 == 1)
                        && (!t14 || t14 == 4 || t14 == 5)) {
                        if (!t3 && t2 == 1) {
                            if (iabs(res) > 3000)
                                res = res > 0 ? sharpn2 + 5 : -sharpn2 - 5;
                            if (iabs(count) > 3000)
                                count = count > 0 ? sharpn2 + 22
                                                  : -sharpn2 - 22;
                            if (iabs(res) < (iabs(count) >> 2)) {
                                if (res > 0) jf[s0] -= 1; else jf[s0] += 1;
                                kf[s0] = res;
                                if (count > 0) jf[s1] += 2;
                                else jf[s1] -= 2;
                                if (iabs(res) > sharpn2) kf[s1] = 0;
                            } else {
                                if (count > 0) jf[s1] += 1;
                                else jf[s1] -= 1;
                            }
                            t3 = 1;
                        } else {
                            if (count > 0) jf[s1] += 2; else jf[s1] -= 2;
                            if (iabs(res) > sharpn2) kf[s1] = 0;
                            if (t3 == 1) t3 = 2;
                            else if (t3 == 2) t3 = 3;
                            else t3 = 0;
                        }
                    } else {
                        if (count > 0) jf[s1] += 2; else jf[s1] -= 2;
                        if (iabs(res) > sharpn2) kf[s1] = 0;
                    }
                    if (t14 == 2) {
                        t14 = 1; t26 = 3;
                        if (t25 > 0) t25 += 1;
                    }
                    if (t14 == 1) {
                        if (t26 < 4) t26 += 1;
                        else { t14 = 2; t26 = 0; }
                    }
                }
                if (iabs(res) > sharpness || iabs(count) > sharpness)
                    t13 = 1;
                if (t14 == 1 || t14 == 2) t27 += 1; else t27 = 0;
                if (t27 > 2) t14 = 1;
                if (t14 == 1) {
                    t14 = 4;
                    if (!t25) { t15 += 1; t25 = 1; }
                    else { t25 += 1; if (t25 > 3) t25 = 0; }
                }
                t1 = 1;
            } else {
                if (iabs(res) > sharpness) {
                    if (res > 0) jf[s0] += 1; else jf[s0] -= 1;
                    t1 += 1; t4 += 1;
                }
                if (iabs(count) > sharpness) {
                    if (count > 0) jf[s1] += 1; else jf[s1] -= 1;
                    t1 += 1; t4 += 1;
                }

                if (t4 < 10) {
                    t17 = (t4 == t10 && t1 == t11) ? 1 : 0;
                } else {
                    if (t4 > 10 || t1 != 15) {
                        if (!t18) { t17 = 1; t18 = 1; }
                        else {
                            t17 = 0; t18 += 1;
                            if (t18 > 15) t18 = 0;
                        }
                    } else if (t4 == t10 && t1 == t11) t17 = 1;
                    else t17 = 0;
                }

                if (t6 > 6000000) { t6 = 0; t22 = 0; }
                else if (t6 > 4000000) {
                    t6 = 0; t22 = (t21 == 1) ? 1 : 0;
                }

                if (t17 == 1 || t1 > 2000003) {
                    if (!t6) {
                        t6 = 1; t14 = 0;
                        if (!t22) t7 += 1;
                        if (t22 == 1) t22 = 0;
                    } else {
                        t6 += 1; t1 += 1;
                        if (t4 > 900000 && t1 == 12) t4 = 8;
                        if (t1 > 3000000) { t1 = 12; t4 = 8; }
                        else if (t1 > 2000006 && t1 < 2500000) {
                            t1 = 14; t4 = 10;
                        }
                        if (!t15) { t14 = 1; t15 = 1; }
                        else {
                            t14 = 0; t15 += 1;
                            if (t15 > 9) t15 = 0;
                        }
                        if (t6 > 15 && t7 < 4) {
                            t6 = 0;
                            if (t19 > 0) t20 += 1;
                        }
                    }
                    if (t4 == 8 || (t4 == 10 && w3 > 16)) {
                        if (w3 < 21) { t4 = 0; w3 += 1; }
                        else if (t4 == 8) w3 = 0;
                        else {
                            if (w4 < 2) { t4 = 8; t1 = 12; w4 += 1; }
                            else { t4 = 0; w4 = 0; }
                        }
                    } else t4 = 0;
                    t8 = 0; t5 = 0; t12 = 0;
                    if (t7 == 3) {
                        if (!t6) { t10 = 10; t11 = 15; }
                        else { t10 = 8; t11 = 12; }
                    } else if (t7 == 1) {
                        if (t9 < 2) { t10 = 10; t11 = 15; t9 += 1; }
                        else {
                            t10 = 8; t11 = 12; t9 += 1;
                            if (t9 >= 3) t9 = 0;
                        }
                    } else if (t7 == 2) { t10 = 8; t11 = 12; }
                    else {
                        if ((t6 == 10 || t6 == 11) && !t7) {
                            t10 = 6; t11 = 9;
                        } else if (t7 >= 4) {
                            if (!t16) {
                                t10 = 10; t11 = 15; t16 = 1;
                                if ((w7 == 2 || w7 == 4) && t24 == 14) {
                                    if (w7 == 2) t1 = 2000005;
                                } else { t4 = 1000000; t1 = 9; }
                            } else if (t16 == 1) {
                                t10 = 8; t11 = 12; t16 = 2; w5 += 1;
                                if (w5 != 3) { t4 = 10; t1 += 2; }
                                else if (t1 > 0 && t1 < 30)
                                    t1 = (-t1) >> 2;
                                else { t4 = 10; t1 += 2; }
                            } else if (t16 == 2) {
                                t10 = 10; t11 = 15; t16 = 3;
                                t4 = 1000000; w6 += 1;
                                if (w6 == 6 || w6 == 10) t1 = 10;
                            } else if (t16 == 3) {
                                t10 = 8; t11 = 12; t16 = 4; t4 = 8;
                                t1 -= 4;
                            } else if (t16 == 4) {
                                t10 = 10; t11 = 15; t16 = 5;
                            } else if (t16 == 5) {
                                t10 = 10; t11 = 15; t16 = 6; t4 = 10;
                                t1 = 2000000;
                            } else if (t16 == 6) {
                                t10 = 8; t11 = 12; t16 = 7; t4 = 8;
                                t1 = 3000000;
                            } else if (t16 == 7) {
                                t10 = 8; t11 = 12; t16 = 8; t4 = 1000000;
                            } else if (t16 == 8) {
                                t10 = 8; t11 = 12;
                                switch (t24) {
                                case 0: t16 = 1; t24 = 1; t4 = 1000000;
                                        break;
                                case 1: t16 = 2; t24 = 2; break;
                                case 2: t16 = 1; t24 = 3; t4 = 1000000;
                                        break;
                                case 3: t16 = 2; t24 = 4; break;
                                case 4: t16 = 1; t24 = 5; t1 = 2999998;
                                        break;
                                case 5: t16 = 0; t24 = 6; break;
                                case 6: t16 = 3; t24 = 7; break;
                                case 7: t16 = 3; t24 = 8; t1 = 7; break;
                                case 8: t16 = 1; t24 = 9; break;
                                case 9: t16 = 8; t24 = 10; t4 = 1000000;
                                        break;
                                case 10: t16 = 1; t24 = 11; t4 = 8;
                                         t1 = 11; break;
                                case 11: t16 = 0; t24 = 12; break;
                                case 12: t16 = 1; t24 = 13; break;
                                case 13: t16 = 0; t24 = 14; break;
                                case 14:
                                    t16 = 1; t24 = 15; w7 += 1;
                                    if (w2 == 0) t1 = 1999978;
                                    else if (w2 == 1) t1 = 1999982;
                                    else t1 = 1999993;
                                    break;
                                case 15:
                                    t16 = 0; t24 = 12;
                                    if (w2 == 1 || w2 == 3) t1 = -5;
                                    else t1 = 2000005;
                                    w2 += 1;
                                    break;
                                }
                            }
                        } else {
                            t10 = (t10 == 8) ? 10 : 8;
                            t11 = (t11 == 12) ? 15 : 12;
                        }
                    }
                } else if (t1 >= 15) {
                    if (!t4) t8 += 1;
                    else { t8 = 0; t5 = 0; t12 = 0; }
                    t1 += 1;
                    if (t4 < 2 && t29 > 0 && t14 == 4) {
                        if (!t31) { t14 = 3; t31 += 1; }
                        else if (t31 == 1) { t14 = 3; t31 += 1; }
                        else if (t31 == 2) {
                            t14 = 0; t15 = 0; t31 += 1;
                        }
                    }
                    if (t14 == 5 && !t35 && t32 > 4 && t32 < 8) {
                        t14 = 1; t32 -= 1; t35 += 1;
                    }
                } else {
                    if (t1 == 6 && !w8) {
                        t1 += 1; w8 += 1; t44 = -100000;
                    } else if (t44 < -90000) {
                        t1 += 1; w8 += 1; t44 = 0;
                    } else {
                        if (t44 < 3) t44 += 1;
                        else { t1 += 3; t44 = 0; }
                    }

                    if (t29 > 0 && (t14 == 4 || t14 == 5 || t39 == 2
                                    || t41 > 0)) {
                        if (t4 < 2 && t1 == 15
                            && (t14 == 4 || (t14 == 5 && t32 > 2))) {
                            if (t32 == 0 || t32 == 2 || t32 == 3
                                || (t32 > 7 && t32 < 500000)) {
                                if (t32 > 7 && t14 == 5) {
                                    t14 = 1; t32 = 1000000;
                                } else {
                                    if (!t34) t34 = 1;
                                    else { t14 = 5; t34 = 0; }
                                }
                            }
                            if (!t32) t14 = 5;
                            t32 += 1;
                        } else if (t32 == 4 || t32 == 5 || t32 == 7) {
                            if (t37 == 4) t14 = 3;
                            else if (t37 == 15) { t14 = 3; t32 += 1; }
                            else if (t32 == 7) {
                                if (t37 > -345000) {
                                    if (t14 == 4) {
                                        if (!t42) t37 -= 10000;
                                        if (t38 > 0) {
                                            t42 += 1;
                                            if (t42 > 0
                                                || (!t42 && t43 > 3)) {
                                                if (!t42) {
                                                    if (t43 == 14) t14 = 3;
                                                    else if (t43 == 24)
                                                        t14 = 4;
                                                    else t14 = 1;
                                                } else t14 = 1;
                                                t39 = 0;
                                                if (t42 > 5) {
                                                    t42 = -1; t43 += 1;
                                                }
                                            } else if (t42 == -1) {
                                                t14 = 3; t39 = 2;
                                                t40 = -2; t42 = 0;
                                            } else t39 = 0;
                                        } else {
                                            t14 = 5; t39 = 1; t42 = 0;
                                        }
                                    } else if (t39 >= 1) {
                                        t38 += 1;
                                        if (t39 < 2) {
                                            if (t38 == 2 || t38 == 4
                                                || t38 == 6 || t38 == 9)
                                                t39 = 2;
                                            else t39 = 0;
                                        } else {
                                            t40 += 1;
                                            if (t38 == 8) {
                                                t39 = 0; t40 = 0;
                                            }
                                            if (t40 > 2) {
                                                t40 = 0; t39 = 0;
                                            }
                                        }
                                        if (t38 >= 1 && t38 <= 10)
                                            t14 = 4;
                                    } else {
                                        t40 = 1;
                                        if (t38 == 1) t39 = 2;
                                    }
                                }
                            }
                            if (t37 >= 0) t37 += 1;
                        } else if (t32 == 6 && t36 < 118) {
                            if (t14 == 4 || t14 == 5 || t41 == 0
                                || t41 > 3) t36 += 1;
                            if (t41 > 3 && t36 < 8) t41 = 0;
                            switch (t36) {
                            case 1: t14 = 1; t41 = 0; break;
                            case 2: t14 = 2; t41 = 0; break;
                            case 3: t14 = 1; t41 = 0; break;
                            case 4: t14 = 3; t41 = 0; break;
                            case 5: t14 = 3; t41 += 1; break;
                            case 6: t14 = 0; t41 = 0; break;
                            case 7: t14 = 2; t41 = 0; break;
                            case 8: t14 = 2; t41 = 4; break;
                            case 15: t14 = 1; t41 = 0; break;
                            case 31: t14 = 3; t41 += 1; break;
                            case 47: t14 = 2; t41 = 0; break;
                            case 100: t14 = 0; t41 += 1; break;
                            case 116: t14 = 2; t41 = 0; break;
                            }
                        }

                        if (t28 < 14 && t1 > 7) {
                            if (t14 == 5 && !t28 && !t33 && t1 > 13
                                && t31 > 0) {
                                t30 = 1; t33 = t30 + 1;
                            } else t30 += 1;
                            if (!t28 && t30 > t33 + 10 && t33 > 0
                                && t14 == 4) {
                                t14 = 3; t15 += 6; t28 += 1;
                            } else if (t28 == 1 && t30 > t33 + 70
                                       && t14 == 4 && t1 == 11) {
                                t15 = 1; t1 = 13; t28 += 1;
                            } else if (t28 == 2 && t31 > 2 && t1 == 15
                                       && t15 > 1) {
                                t15 = 15; t33 = t30; t1 = 6; t28 += 1;
                            } else if (t28 == 3 && t30 > t33 + 3
                                       && t31 > 2) {
                                t15 = 0; t28 += 1;
                            } else if (t28 == 5 && t30 > t33 + 22
                                       && t31 > 2 && t1 == 12) {
                                t15 = 3; t1 = 9; t28 += 1;
                            } else if (t28 == 4 && t30 > t33 + 6
                                       && t1 == 15) {
                                t14 = 1; t15 += 6; t1 += 1; t28 += 1;
                            } else if (t28 == 6 && t30 > t33 + 54) {
                                t14 = 2; t15 = 3; t1 = 3; t28 += 1;
                            } else if (t28 == 7 && t30 > t33 + 57) {
                                t14 = 2; t15 = 8; t1 = 8; t28 += 1;
                            } else if (t28 == 8 && t30 > t33 + 84) {
                                t14 = 2; t15 = 7; t1 = 7; t28 += 1;
                            } else if (t28 == 9 && t30 > t33 + 111) {
                                t14 = 2; t15 = 3; t1 = 7; t28 += 1;
                            } else if (t28 == 10 && t30 > t33 + 116) {
                                t14 = 1; t15 = 0; t1 = 1; t4 = 8;
                                t28 += 1;
                            } else if (t28 == 11 && t30 > t33 + 185) {
                                t14 = 0; t15 = 4; t1 = -17; t28 += 1;
                            } else if (t28 == 12 && t30 > t33 + 187) {
                                t14 = 3; t15 = 3; t1 = -19; t28 += 1;
                            } else if (t30 == t33 + 9) {
                                t1 += (12 - t4) >> 2;
                                t4 = 10;
                            } else if (t28 > 0 && t1 == 15 && w1 < 11) {
                                if (t4 != 10) {
                                    if (w1 == 4 || w1 == 10) t4 = 10;
                                    w1 += 1;
                                }
                            } else if (t28 == 13 && t30 > t33 + 188) {
                                t14 = 0; t15 = 3; t1 = -30; t28 += 1;
                            }
                        }
                    }
                }

                if (t8 > 6 && !t4 && t1 > 1 && t1 < 15) {
                    t5 += 1;
                    if (t5 < 35) {
                        t1 = 0;
                        if (!t13) { t12 = 1; t13 = 1; }
                        else {
                            t12 = 0; t13 += 1;
                            if (t13 > 3) t13 = 0;
                        }
                    } else t12 = 0;
                }
                if (t1 > 15 && t1 < 1000000) {
                    t1 = 0; t4 = 0; t29 += 1;
                }
            }

            if (iabs(res) > sharpness && iabs(res) <= sharpness + 20
                && iabs(count) > sharpness
                && iabs(count) <= sharpness + 20) {
                if (res > 0 && count < 0) {
                    jf[s0] += 1; jf[s1] -= 1;
                    sharp_on[s0] = 2; sharp_on[s1] = 3;
                } else if (res < 0 && count > 0) {
                    jf[s0] -= 1; jf[s1] += 1;
                    sharp_on[s0] = 3; sharp_on[s1] = 2;
                }
            }

            if (ladder_on) {
                if (res > 10 && res < 32) {
                    if (iabs(count) >= 23) {
                        if (res < 16) {
                            if (count > 0 && count < 32 && res > 11)
                                jf[s1] += 1;
                            jf[s0] += 1;
                            a = 0; j += 2; continue;
                        } else {
                            jf[s0] += a ? 1 : 2;
                            a = 0; j += 2; continue;
                        }
                    }
                } else if (res > -32 && res < -10) {
                    if (iabs(count) >= 23) {
                        if (res > -16) {
                            if (count > -32 && count < 0 && res < -11)
                                jf[s1] -= 1;
                            jf[s0] -= 1;
                            a = 0; j += 2; continue;
                        } else {
                            jf[s0] -= a ? 1 : 2;
                            a = 0; j += 2; continue;
                        }
                    }
                }
                a = 0;
                if (count > 10 && count < 32) {
                    if (iabs(res) >= 23) {
                        if (count < 16) {
                            if (res > 0 && res < 32 && count > 11)
                                jf[s0] += 1;
                            jf[s1] += 1;
                        } else { jf[s1] += 2; a = 1; }
                    }
                } else if (count > -32 && count < -10) {
                    if (iabs(res) >= 23) {
                        if (count > -16) {
                            if (res > -32 && res < 0 && count < -11)
                                jf[s0] -= 1;
                            jf[s1] -= 1;
                        } else { jf[s1] -= 2; a = 1; }
                    }
                }
            }
            j += 2;
        }
    }
}

/* ------------------------------------------------------------------ */
/* q<LOW7 LL2 window ladders (models/encoder._very_low_q_cleanup) and
 * q<LOW6 band dead-zoning (_lowest_q_band_cleanup)                    */

static void vlq_zero_bands(int16_t *pf, long cnt, int x5, int x6, int e34)
{
    long c2 = cnt << 1;
    long e = 2 * SZ + D;
    int thr = e34 ? 34 : x5;
    if (iabs(pf[c2 + D]) < x6) pf[c2 + D] = 0;
    if (iabs(pf[c2 + D + 1]) < x6) pf[c2 + D + 1] = 0;
    if (iabs(pf[c2 + 3*D]) < x6) pf[c2 + 3*D] = 0;
    if (iabs(pf[c2 + 3*D + 1]) < x6) pf[c2 + 3*D + 1] = 0;
    if (iabs(pf[c2 + 2*SZ]) < x6 + 6) pf[c2 + 2*SZ] = 0;
    if (iabs(pf[c2 + 2*SZ + 1]) < x6 + 6) pf[c2 + 2*SZ + 1] = 0;
    if (iabs(pf[c2 + 2*SZ + N]) < x6 + 6) pf[c2 + 2*SZ + N] = 0;
    if (iabs(pf[c2 + 2*SZ + N + 1]) < x6 + 6) pf[c2 + 2*SZ + N + 1] = 0;
    if (iabs(pf[c2 + e]) < thr) pf[c2 + e] = 0;
    if (iabs(pf[c2 + e + 1]) < thr) pf[c2 + e + 1] = 0;
    if (iabs(pf[c2 + e + N]) < thr) pf[c2 + e + N] = 0;
    if (iabs(pf[c2 + e + N + 1]) < thr) pf[c2 + e + N + 1] = 0;
}

static void vlq_zero_l2(int16_t *pf, long cnt)
{
    if (iabs(pf[cnt + 128]) < 11) pf[cnt + 128] = 0;
    if (iabs(pf[cnt + SZ]) < 12) pf[cnt + SZ] = 0;
    if (iabs(pf[cnt + SZ + 128]) < 13) pf[cnt + SZ + 128] = 0;
}

/* q<=LOW9 isolated-coefficient zeroing in the lower LL1 half
 * (models/encoder.py _low_q_ll1_cleanup; encoder/nhw_encoder.c:285-309).
 * Sequential: a zeroed element weakens its right neighbor's check. */
void nhw_low_q_ll1_cleanup(int16_t *pf, int x1, int ratio)
{
    int r, j;
    for (r = 128; r < 256; r++) {
        long base = (long)r * N;
        for (j = 0; j < D; j++) {
            long scan = base + j;
            int v = iabs(pf[scan]);
            if (v >= ratio && v < x1) {
                if (iabs(pf[scan - 1]) < ratio
                        && iabs(pf[scan + 1]) < ratio)
                    pf[scan] = 0;
                else if (v == ratio
                         && (iabs(pf[scan - 1]) < ratio
                             || iabs(pf[scan + 1]) < ratio))
                    pf[scan] = 0;
            }
        }
    }
}

void nhw_very_low_q_cleanup(int16_t *pf, int low9,
                            int x1, int x2, int x3, int x4, int x5,
                            int x6, int x7)
{
    long carry = 0;
    int r, j;
    (void)x1;

    /* pass 1: 4-px horizontal windows in LL2 rows */
    for (r = 0; r < 128; r++) {
        long base = (long)r * N;
        for (j = 0; j < 124; j++) {
            long scan = base + j;
            int p0 = pf[scan], p1 = pf[scan+1], p2 = pf[scan+2];
            int p3 = pf[scan+3], p4 = pf[scan+4];
            if (iabs(p4-p0) < x1 && iabs(p4-p3) < x1 && iabs(p1-p0) < x1
                && iabs(p3-p1) < x1 && iabs(p3-p2) < x2 - 2) {
                long c;
                if (p3 - p1 > 5 && p2 - p3 >= 0) pf[scan+2] = p3;
                else if (p1 - p3 > 5 && p2 - p3 <= 0) pf[scan+2] = p3;
                else if (p1 - p3 > 5 && p2 - p1 >= 0) pf[scan+2] = p1;
                else if (p3 - p1 > 5 && p2 - p1 <= 0) pf[scan+2] = p1;
                else if (p3 - p2 > 0 && p2 - p1 > 0) {}
                else if (p1 - p2 > 0 && p2 - p3 > 0) {}
                else pf[scan+2] = (int16_t)((p3 + p1) >> 1);
                for (c = 1; c < 4; c++)
                    vlq_zero_bands(pf, scan + c, x5, x6, 0);
                carry = 4;
                if (low9)
                    for (c = 1; c < 4; c++) vlq_zero_l2(pf, scan + c);
            } else if (iabs(p4-p0) < x2 + 1 && iabs(p4-p3) < x2 + 1
                       && iabs(p1-p0) < x2 + 1) {
                if (iabs(p3-p1) < x2 + 6 && iabs(p3-p2) < x2 + 6) {
                    if ((p3 - p2 >= 0 && p2 - p1 >= 0)
                        || (p3 - p2 <= 0 && p2 - p1 <= 0)) {
                        long c;
                        for (c = 1; c < 4; c++)
                            vlq_zero_bands(pf, scan + c, x5, x6, 0);
                        carry = 4;
                        if (low9)
                            for (c = 1; c < 4; c++)
                                vlq_zero_l2(pf, scan + c);
                    }
                }
            }
        }
    }

    /* pass 2: vertical cross windows */
    for (r = 0; r < 126; r++) {
        long base = (long)r * N;
        for (j = 0; j < 126; j++) {
            long scan = base + j;
            if (iabs(pf[scan+1] - pf[scan + 4*D + 1]) < x3
                && iabs(pf[scan + 2*D] - pf[scan + 2*D + 2]) < x3) {
                if (iabs(pf[scan + 2*D + 1] - pf[scan + 2*D]) < x4 - 1
                    && iabs(pf[scan+1] - pf[scan + 2*D + 1]) < x4) {
                    int e = (pf[scan+1] + pf[scan + 4*D + 1]
                             + pf[scan + 2*D] + pf[scan + 2*D + 2] + 2)
                            >> 2;
                    if (iabs(e - pf[scan + 2*D]) < 5
                        || iabs(e - pf[scan + 2*D + 2]) < 5)
                        pf[scan + 2*D + 1] = (int16_t)e;
                    carry = scan + 2*D + 1;
                    vlq_zero_bands(pf, carry, 32, x6, 0);
                    if (low9) {
                        long e2;
                        for (e2 = 0; e2 < 3; e2++)
                            vlq_zero_l2(pf, carry + e2 - 1);
                    }
                }
            }
        }
    }

    /* pass 3: second cross variant (stale carry semantics) */
    for (r = 0; r < 126; r++) {
        long base = (long)r * N;
        for (j = 0; j < 126; j++) {
            long scan = base + j;
            if (iabs(pf[scan+2] - pf[scan+1]) < x3
                && iabs(pf[scan+1] - pf[scan]) < x3) {
                if (iabs(pf[scan] - pf[scan + 2*D]) < x3
                    && iabs(pf[scan+2] - pf[scan + 2*D + 2]) < x3) {
                    if (iabs(pf[scan + 4*D + 1] - pf[scan + 2*D]) < x3
                        && iabs(pf[scan + 2*D] - pf[scan + 2*D + 1])
                           < x4) {
                        int e = (pf[scan+1] + pf[scan + 4*D + 1]
                                 + pf[scan + 2*D] + pf[scan + 2*D + 2]
                                 + 1) >> 2;
                        if (iabs(e - pf[scan + 2*D]) < 5
                            || iabs(e - pf[scan + 2*D + 2]) < 5)
                            pf[scan + 2*D + 1] = (int16_t)e;
                        carry = scan + 2*D + 1;
                        vlq_zero_bands(pf, carry, 32, x6, 0);
                    }
                    if (low9) {
                        long e2;
                        for (e2 = 0; e2 < 3; e2++)
                            vlq_zero_l2(pf, carry + e2 - 1);
                    }
                }
            }
        }
    }

    /* pass 4: low9 3-px flats */
    if (low9) {
        for (r = 0; r < 128; r++) {
            long base = (long)r * N;
            for (j = 0; j < 126; j++) {
                long scan = base + j;
                if (iabs(pf[scan+2] - pf[scan+1]) < x7
                    && iabs(pf[scan+2] - pf[scan]) < x7
                    && iabs(pf[scan+1] - pf[scan]) < x7) {
                    long cnt = scan + 1;
                    vlq_zero_bands(pf, cnt, 34, x6, 1);
                    vlq_zero_l2(pf, cnt);
                }
            }
        }
    }
}

void nhw_lowest_q_band_cleanup(int16_t *pf, const int16_t *r3pad,
                               int ratio, int gt_low10,
                               int x1, int x2, int x3, int x4, int x5)
{
    int r, j;
    for (r = 0; r < D; r++) {
        long base = (long)r * N;
        long i = base;
        for (j = D; j < 2 * D; j++) {
            long scan = base + j;
            int v = pf[scan];
            if (iabs(v) >= ratio && iabs(v) < x3 + 2) {
                if (iabs(r3pad[(((i >> 1) + (j - D)) >> 1) + 128]) < x4)
                    pf[scan] = 0;
                else if (iabs(v + pf[scan-1]) < x5
                         && iabs(pf[scan+1]) < x5) {
                    pf[scan] = 0; pf[scan-1] = 0;
                } else if (iabs(v + pf[scan+1]) < x5
                           && iabs(pf[scan-1]) < x5) {
                    pf[scan] = 0; pf[scan+1] = 0;
                }
            }
            v = pf[scan];
            if (iabs(v) >= ratio && iabs(v) < x3) {
                if (iabs(pf[scan-1]) < ratio && iabs(pf[scan+1]) < ratio)
                    pf[scan] = 0;
            }
        }
    }
    for (r = D; r < 2 * D; r++) {
        long base = (long)r * N;
        long i = base - 2 * SZ;
        for (j = 0; j < D; j++) {
            long scan = base + j;
            int v = pf[scan];
            if (iabs(v) >= ratio && iabs(v) < x1 + 2) {
                if (iabs(r3pad[(((i >> 1) + j) >> 1) + (SZ >> 1)]) < x4)
                    pf[scan] = 0;
                else if (iabs(v + pf[scan-1]) < x5
                         && iabs(pf[scan+1]) < x5) {
                    pf[scan] = 0; pf[scan-1] = 0;
                } else if (iabs(v + pf[scan+1]) < x5
                           && iabs(pf[scan-1]) < x5) {
                    pf[scan] = 0; pf[scan+1] = 0;
                }
            }
            v = pf[scan];
            if (iabs(v) >= ratio && iabs(v) < x1) {
                if (iabs(pf[scan-1]) < ratio && iabs(pf[scan+1]) < ratio)
                    pf[scan] = 0;
                else if (iabs(v) < x1 - 4) pf[scan] = 0;
            }
        }
        for (j = D; j < 2 * D - 1; j++) {
            long scan = base + j;
            int v = pf[scan];
            if (iabs(v) >= ratio && iabs(v) < x2 + 1) {
                if (iabs(r3pad[(((i >> 1) + (j - D)) >> 1)
                               + (SZ >> 1) + 128]) < x4 + 1)
                    pf[scan] = 0;
                else if (iabs(v + pf[scan-1]) < x5
                         && iabs(pf[scan+1]) < x5) {
                    pf[scan] = 0; pf[scan-1] = 0;
                } else if (iabs(v + pf[scan+1]) < x5
                           && iabs(pf[scan-1]) < x5) {
                    pf[scan] = 0; pf[scan+1] = 0;
                }
            }
            v = pf[scan];
            if (iabs(v) >= ratio && iabs(v) < x2) {
                if (iabs(pf[scan-1]) < ratio && iabs(pf[scan+1]) < ratio) {
                    if (gt_low10) {
                        if (v >= 16) pf[scan] = 7;
                        else if (v <= -16) pf[scan] = -7;
                        else pf[scan] = 0;
                    } else pf[scan] = 0;
                } else if (iabs(v) < x2 - 5) {
                    if (gt_low10) {
                        if (v >= 16) pf[scan] = 7;
                        else if (v <= -16) pf[scan] = -7;
                        else pf[scan] = 0;
                    } else pf[scan] = 0;
                }
            }
        }
    }
}

/* ------------------------------------------------------------------ */
/* UV helpers (models/encoder.py): compare ladder, LL smoothing,
 * sentinel marking; and the Y pair promotions                         */

void nhw_uv_compare_ladder(int16_t *jf, const int16_t *pf,
                           const int16_t *rf, int strict, int oob0)
{
    int r, j;
    for (r = 0; r < 128; r++) {
        for (j = 0; j < 128; j++) {
            long e = (long)r * D + j;
            long cnt = (long)r * 128 + j;
            int scan = pf[e] - rf[cnt];
            int nxt = pf[e + 1] - (cnt + 1 < 16384 ? rf[cnt + 1] : oob0);
            int k;
            if (scan > 10) k = -6;
            else if (scan > 7) k = -3;
            else if (scan > 4) k = -2;
            else if (scan > 3) k = -1;
            else if (scan > 2 && (strict ? nxt > 0 : nxt >= 0)) k = -1;
            else if (scan < -10) k = 6;
            else if (scan < -7) k = 3;
            else if (scan < -4) k = 2;
            else if (scan < -3) k = 1;
            else if (scan < -2 && (strict ? nxt < 0 : nxt <= 0)) k = 1;
            else k = 0;
            jf[e] = (int16_t)(rf[cnt] + k);
        }
    }
}

void nhw_uv_ll_smooth(int16_t *pf)
{
    int r, j;
    for (r = 0; r < 62; r++) {
        for (j = 0; j < 62; j++) {
            long scan = (long)r * D + j;
            if (iabs(pf[scan+1] - pf[scan + 2*D + 1]) < 5
                && iabs(pf[scan + D] - pf[scan + D + 2]) < 5) {
                if (iabs(pf[scan + D + 1] - pf[scan + D]) < 7
                    && iabs(pf[scan+1] - pf[scan + D + 1]) < 8) {
                    pf[scan + D + 1] = (int16_t)((pf[scan+1]
                        + pf[scan + 2*D + 1] + pf[scan + D]
                        + pf[scan + D + 2] + 2) >> 2);
                }
            }
        }
    }
    for (r = 0; r < 62; r++) {
        for (j = 0; j < 62; j++) {
            long scan = (long)r * D + j;
            if (iabs(pf[scan+2] - pf[scan+1]) < 5
                && iabs(pf[scan+1] - pf[scan]) < 5) {
                if (iabs(pf[scan] - pf[scan + D]) < 5
                    && iabs(pf[scan+2] - pf[scan + D + 2]) < 5) {
                    if (iabs(pf[scan + 2*D + 1] - pf[scan + D]) < 5
                        && iabs(pf[scan + D] - pf[scan + D + 1]) < 8) {
                        pf[scan + D + 1] = (int16_t)((pf[scan+1]
                            + pf[scan + 2*D + 1] + pf[scan + D]
                            + pf[scan + D + 2] + 1) >> 2);
                    }
                }
            }
        }
    }
}

void nhw_pair_promotion(int16_t *pf)
{
    int r;
    long j;
    for (r = 1; r < 255; r++) {
        long base = (long)r * N;
        for (j = D + 1; j < 2 * D - 1; j++) {
            long a = base + j;
            int v = pf[a];
            if (v > 4 && v < 8) {
                if (pf[a-1] > 3 && pf[a-1] <= 7 && pf[a+1] > 3
                    && pf[a+1] <= 7) {
                    pf[a] = 12700; pf[a-1] = 10100; pf[a+1] = 10100;
                }
            } else if (v < -4 && v > -8) {
                if (pf[a-1] < -3 && pf[a-1] >= -7 && pf[a+1] < -3
                    && pf[a+1] >= -7) {
                    pf[a] = 12900; pf[a-1] = 10100; pf[a+1] = 10100;
                }
            } else if (v == -7 && (pf[a+1] == -6 || pf[a+1] == -7)) {
                pf[a] = 10204; pf[a+1] = 10100;
            } else if (v == 7 && pf[a+1] == 7) {
                pf[a] = 10300; pf[a+1] = 10100;
            } else if (v == 8) {
                if ((pf[a-1] & 65534) == 6 || (pf[a+1] & 65534) == 6)
                    pf[a] = 10;
                else if (pf[a+1] == 8) { pf[a] = 9; pf[a+1] = 9; }
            } else if (v == -8) {
                if (((-pf[a-1]) & 65534) == 6
                    || ((-pf[a+1]) & 65534) == 6) pf[a] = -9;
                else if (pf[a+1] == -8) { pf[a] = -9; pf[a+1] = -9; }
            }
        }
    }
    for (r = 257; r < 511; r++) {
        long base = (long)r * N;
        for (j = 1; j < D - 1; j++) {
            long a = base + j;
            int v = pf[a];
            if (v > 4 && v < 8) {
                if (pf[a-1] > 3 && pf[a-1] <= 7 && pf[a+1] > 3
                    && pf[a+1] <= 7) {
                    pf[a] = 12700; pf[a-1] = 10100; pf[a+1] = 10100;
                }
            } else if (v < -4 && v > -8) {
                if (pf[a-1] < -3 && pf[a-1] >= -7 && pf[a+1] < -3
                    && pf[a+1] >= -7) {
                    pf[a] = 12900; pf[a-1] = 10100; pf[a+1] = 10100;
                }
            } else if (v == -6 || v == -7) {
                if (pf[a+1] == -7) {
                    pf[a] = 10204; pf[a+1] = 10100;
                } else if (pf[a-N] == -7) {
                    if (iabs(pf[a + D]) < 8) pf[a + D] = 10204;
                    pf[a] = 10100;
                }
            } else if (v == 7) {
                if (pf[a+1] == 7) {
                    pf[a] = 10300; pf[a+1] = 10100;
                } else if (pf[a-N] == 7) {
                    if (iabs(pf[a + D]) < 8) pf[a + D] = 10300;
                    pf[a] = 10100;
                }
            } else if (v == 8) {
                if ((pf[a-1] & 65534) == 6 || (pf[a+1] & 65534) == 6)
                    pf[a] = 10;
            } else if (v == -8) {
                if (((-pf[a-1]) & 65534) == 6
                    || ((-pf[a+1]) & 65534) == 6) pf[a] = -9;
            }
        }
    }
}

/* ------------------------------------------------------------------ */
/* decoder raster passes (models/decoder.py)                           */

static int lap8(const int16_t *a, long scan, int stride)
{
    return (a[scan] << 3) - a[scan-1] - a[scan+1]
           - a[scan-stride] - a[scan+stride]
           - a[scan-stride-1] - a[scan+stride-1]
           - a[scan-stride+1] - a[scan+stride+1];
}

/* edge-detect marking (decoder/nhw_decoder.c:789-839 behavior):
 * returns the number of marks written to marks_out (row*256+col) */
long nhw_dering_mark(int16_t *proc, int32_t *marks_out)
{
    int r, c;
    long nmarks = 0;
    for (r = 1; r < 255; r++) {
        for (c = 1; c < 254; c += 2) {
            long scan = (long)r * N + c;
            int res = lap8(proc, scan, N);
            int cnt = lap8(proc, scan + 1, N);
            int mark_col;
            if (res > 41 && res < 108 && cnt < 16) mark_col = c;
            else if (res < -41 && res > -108 && cnt > -16) mark_col = c;
            else if (cnt > 41 && cnt < 108 && res < 16) mark_col = c + 1;
            else if (cnt < -41 && cnt > -108 && res > -16) mark_col = c + 1;
            else continue;
            proc[(long)r * N + mark_col] += 16000;
        }
    }
    for (r = 1; r < 255; r++) {
        for (c = 0; c < D; c++) {
            long scan = (long)r * N + c;
            if (proc[scan] > 10000) {
                marks_out[nmarks++] = r * D + c;
                proc[scan] -= 16000;
            }
        }
    }
    return nmarks;
}

/* isolated-coefficient damping (decoder/nhw_decoder.c:660-711) */
void nhw_isolated_smooth(int16_t *flat, int diag_thr)
{
    int r, c;
    for (r = 1; r < 255; r++) {
        for (c = 1; c < 255; c++) {
            long scan = (long)r * N + c;
            int v = flat[scan];
            if (v <= 8 && v >= -8) continue;
            if (iabs(flat[scan-N-1]) > diag_thr || iabs(flat[scan-N]) > 8
                || iabs(flat[scan-N+1]) > diag_thr
                || iabs(flat[scan-1]) > 8 || iabs(flat[scan+1]) > 8
                || iabs(flat[scan+N-1]) > diag_thr
                || iabs(flat[scan+N]) > 8
                || iabs(flat[scan+N+1]) > diag_thr) continue;
            if (r >= 128 || c >= 128)
                flat[scan] = (int16_t)(v > 0 ? v - 1 : v + 1);
        }
    }
}

/* chroma laplacian sharpen (decoder/nhw_decoder.c:1082-1109) */
void nhw_uv_sharpen(int16_t *proc, int thr)
{
    int r, c;
    for (r = 1; r < 255; r++) {
        for (c = 1; c < 255; c++) {
            long scan = (long)r * D + c;
            int res = lap8(proc, scan, D);
            if (res > thr) proc[scan] += (res > 160) ? 3 : 2;
            else if (res < -thr) proc[scan] -= (res < -160) ? 3 : 2;
        }
    }
}

/* ------------------------------------------------------------------ */
/* offsetY_recons256: full LL2 + level-2 requantization driver
 * (ops/requant.py offset_y_recons256; encoder/image_processing.c:2600-
 * 3190).  highres_tmp receives the 16384-entry LL2 snapshot at part=0;
 * highres_mem (may be NULL) re-injects Y_highres positions at q>LOW5.  */

void nhw_offset_y_recons256(int16_t *jf, int16_t *pf, int quality, int m1,
                            int part, int16_t *highres_tmp,
                            const int32_t *highres_mem, int n_mem)
{
    const int low3p = quality > 17, low4p = quality > 16,
              low5p = quality > 15;
    int r;

    /* greedy odd-run marking in LL2 rows (image_processing.c:2608) */
    if (low3p) {
        for (r = 0; r < 128; r++) {
            long base = (long)r * N;
            int j = 0;
            while (j < 125) {
                long a = base + j;
                int d = pf[a] - pf[a + 3];
                if ((pf[a] & 1) && (pf[a + 1] & 1) && (pf[a + 2] & 1)
                        && (pf[a + 3] & 1) && (d > 1 || d < -1)) {
                    if (!part) {
                        pf[a] += 16000; pf[a + 1] += 16000;
                        pf[a + 2] += 16000; pf[a + 3] += 16000;
                    } else {
                        pf[a] += 16000; pf[a + 2] += 16000;
                    }
                    j += 4;
                } else j += 1;
            }
        }
    }

    /* odd-pattern propagation + part=1 LSB masking (2640-2695) */
    for (r = 0; r < 128; r++) {
        long base = (long)r * N;
        int j = 0;
        while (j < 128) {
            long a = base + j;
            int v = pf[a];
            if (v > 10000) {
                if (!part) jf[a] = pf[a];
                else {
                    int nxt;
                    pf[a] = (int16_t)(v - 16000);
                    jf[a] = pf[a];
                    nxt = pf[a + 1];
                    if (nxt > 0 && nxt < 256)
                        jf[a + 1] = (int16_t)(nxt & 65534);
                    else jf[a + 1] = pf[a + 1];
                    j += 1;
                }
                j += 1;
                continue;
            }
            if ((v & 1) && j > 0 && (pf[a + 1] & 1)) {
                if (j < 126 && (pf[a + 2] & 1)) {
                    int d = v - pf[a + 2];
                    if ((d > 1 || d < -1) && low3p) pf[a + 1] += 1;
                } else if (base < SZ - N - 2 && (pf[a + N] & 1)
                           && (pf[a + N + 1] & 1)
                           && !(pf[a + N + 2] & 1)) {
                    if (pf[a + N] < 10000 && low3p) pf[a + N] += 1;
                }
            } else if ((v & 1) && base >= N && base < SZ - 3 * N) {
                if ((pf[a + N] & 1) && (pf[a + N + 1] & 1)) {
                    if ((pf[a + 2 * N] & 1) && !(pf[a + 3 * N] & 1)) {
                        if (pf[a + N] < 10000 && low3p) pf[a + N] += 1;
                    }
                }
            }
            if (part) {
                if (v > 0 && v < 256) jf[a] = (int16_t)(pf[a] & 65534);
                else jf[a] = pf[a];
            }
            j += 1;
        }
    }

    /* part=0: strip sentinels, save highres_tmp, mask LSBs (2697) */
    if (!part) {
        long t = 0;
        int j;
        for (r = 0; r < 128; r++) {
            long base = (long)r * N;
            for (j = 0; j < 128; j++) {
                long a = base + j;
                int v = pf[a];
                if (v < 10000) {
                    highres_tmp[t] = (int16_t)v;
                    jf[a] = (v >= 0 && v < 256) ? (int16_t)(v & 65534)
                                                : pf[a];
                } else {
                    pf[a] = (int16_t)(v - 16000);
                    highres_tmp[t] = pf[a];
                    jf[a] = pf[a];
                }
                t++;
            }
        }
        if (low5p && highres_mem) {
            int k;
            for (k = 0; k < n_mem; k++) {
                long mem = highres_mem[k];
                long jj = mem >> 7, aa = mem & 127;
                jf[(jj << 9) + aa] = highres_tmp[mem];
            }
        }
    }

    /* q>LOW4: band pair/sentinel promotions (2759-2853) */
    if (low4p) {
        int region, j;
        for (region = 0; region < 2; region++) {
            int r0 = region ? 128 : 0, r1_ = region ? 255 : 128;
            int j0 = region ? 1 : 129;
            for (r = r0; r < r1_; r++) {
                long base = (long)r * N;
                j = j0;
                while (j < 255) {
                    long a = base + j;
                    int v = pf[a], consumed = 0;
                    if (v > 3 && v < 8) {
                        if (pf[a - 1] > 3 && pf[a - 1] <= 7) {
                            if (pf[a + 1] > 3 && pf[a + 1] <= 7) {
                                pf[a - 1] = 15300; pf[a] = 0;
                                jf[a] = 5; jf[a + 1] = 5;
                                consumed = 1;
                            } else if (pf[a + N - 1] > 3
                                       && pf[a + N - 1] <= 7) {
                                if (pf[a + N] > 3 && pf[a + N] <= 7) {
                                    pf[a - 1] = 15500; jf[a] = 5;
                                    pf[a + N - 1] = 15500;
                                    jf[a + N] = 5; pf[a + N] = 0;
                                    consumed = 1;
                                }
                            }
                        }
                    } else if (v > -8 && v < -3) {
                        if (pf[a - 1] > -8 && pf[a - 1] <= -4) {
                            if (pf[a + 1] > -8 && pf[a + 1] <= -4) {
                                pf[a - 1] = 15400; pf[a] = 0;
                                jf[a] = -6; jf[a + 1] = -5;
                                consumed = 1;
                            } else if (pf[a + N - 1] > -8
                                       && pf[a + N - 1] <= -4) {
                                if (pf[a + N] > -8 && pf[a + N] <= -4) {
                                    pf[a - 1] = 15600; jf[a] = -5;
                                    pf[a + N - 1] = 15600;
                                    jf[a + N] = -5; pf[a + N] = 0;
                                    consumed = 1;
                                }
                            }
                        }
                    }
                    j += 1 + consumed;
                }
            }
        }
        if (!part) {
            /* 15700/15800 pair markers (2855-2906) */
            for (region = 0; region < 2; region++) {
                int r0 = region ? 128 : 0, r1_ = region ? 256 : 128;
                int j0 = region ? 0 : 128;
                for (r = r0; r < r1_; r++) {
                    long base = (long)r * N;
                    j = j0;
                    while (j < 255) {
                        long a = base + j;
                        int v = pf[a], w = pf[a + 1];
                        if (v >= 5 && v <= 7 && w >= 5 && w <= 7) {
                            pf[a] = 15700; j += 1;
                        } else if (v >= -7 && v <= -5
                                   && w >= -7 && w <= -5) {
                            pf[a] = 15800; j += 1;
                        }
                        j += 1;
                    }
                }
            }
        }
    }

    /* band quantization with marker expansion (2909-3133) */
    nhw_quantize_band(jf, pf, !low4p ? 1 : 0, m1, part, 0, 128, 128, 256);
    nhw_quantize_band(jf, pf, !low4p ? 1 : 0, m1, part, 128, 256, 0, 256);

    /* part=0: isolated-coefficient damping (3135-3189); the reference
     * loop runs i < 2*IM_SIZE - 2*IM_DIM, i.e. rows 1..254 only */
    if (!part) {
        int thr_diag = low4p ? 8 : 16, j;
        for (r = 1; r < 255; r++) {
            long base = (long)r * N;
            for (j = 1; j < 255; j++) {
                long e = base + j;
                int v = jf[e];
                if ((v < 0 ? -v : v) < 8) continue;
                if (iabs(jf[e - N - 1]) >= thr_diag
                        || iabs(jf[e - N]) >= 8
                        || iabs(jf[e - N + 1]) >= thr_diag
                        || iabs(jf[e - 1]) >= 8 || iabs(jf[e + 1]) >= 8
                        || iabs(jf[e + N - 1]) >= thr_diag
                        || iabs(jf[e + N]) >= 8
                        || iabs(jf[e + N + 1]) >= thr_diag) continue;
                if (r >= 128 || j >= 128)
                    jf[e] += (int16_t)(jf[e] > 0 ? -1 : 1);
            }
        }
    }
}

/* ------------------------------------------------------------------ */
/* UV band sentinels 12400/12600/12900/13000
 * (models/encoder.py _uv_sentinel_marking; encoder/nhw_encoder.c:2372) */

void nhw_uv_sentinel_marking(int16_t *pf, const int16_t *rf,
                             long rf_len, int res_uv)
{
    /* the reference's count register advances by 2 on each 12400/12600
     * placement; a placement at a row's final position overruns the row
     * and desynchronizes count from the grid for every later row
     * (encoder/nhw_encoder.c:2372-2424).  rf must carry a tail past
     * 16384 entries for the drift overrun (zero-filled heap slack). */
    long count = 0, i;
    for (i = 0; i < 32768; i += 256) {
        long scan = i;
        int j = 0;
        while (j < 128) {
            int d0 = pf[scan] - (count < rf_len ? rf[count] : 0);
            int d1 = pf[scan + 1]
                     - (count + 1 < rf_len ? rf[count + 1] : 0);
            int placed = 0, k;
            static const long offs[3] = {128, 32768, 32896};
            if (d0 > 3 && d0 < 7 && d1 > 2 && d1 < 7) {
                for (k = 0; k < 3; k++)
                    if (iabs(pf[scan + offs[k]]) < 8) {
                        pf[scan + offs[k]] = 12400;
                        placed = 1;
                        break;
                    }
            } else if (d0 < -3 && d0 > -7 && d1 < -2 && d1 > -8) {
                for (k = 0; k < 3; k++)
                    if (iabs(pf[scan + offs[k]]) < 8) {
                        pf[scan + offs[k]] = 12600;
                        placed = 1;
                        break;
                    }
            }
            if (placed) {
                count += 2; scan += 2; j += 2;
                continue;
            }
            if (iabs(d0) > res_uv) {
                int code = 0;
                if (d0 > 0) code = 12900;
                else if (d0 == -5) code = d1 < 0 ? 13000 : 0;
                else code = 13000;
                if (code)
                    for (k = 0; k < 3; k++)
                        if (iabs(pf[scan + offs[k]]) < 8) {
                            pf[scan + offs[k]] = (int16_t)code;
                            break;
                        }
            }
            count += 1; scan += 1; j += 1;
        }
    }
}

/* ------------------------------------------------------------------ */
/* res1/res3/res5 positional stream builder
 * (ops/residue.py build_positional_stream; encoder/nhw_encoder.c:1498) */

void nhw_build_positional_stream(int16_t *rf, const int32_t *word_tab,
                                 const int16_t *repl_tab,
                                 int32_t *positions, long *n_pos,
                                 int32_t *words, long *n_words)
{
    long np_ = 0, nw = 0;
    int r;
    for (r = 0; r < D; r++) {
        int j = 0;
        while (j < D) {
            long scan = (long)r * D + j;
            int code;
            if (j == D - 2) {
                rf[scan] = 0;
                rf[scan + 1] = 0;
                positions[np_++] = D - 2;
                j += 2;
                continue;
            }
            code = rf[scan];
            if (code >= 0 && code < 256 && word_tab[code] >= 0) {
                positions[np_++] = j;
                rf[scan] = repl_tab[code];
                words[nw++] = word_tab[code];
            }
            j += 1;
        }
    }
    *n_pos = np_;
    *n_words = nw;
}

/* ------------------------------------------------------------------ */
/* offsetUV_recons256 (ops/requant.py offset_uv_recons256;
 * encoder/image_processing.c:3192-3353).  256-wide chroma planes.     */

static void uv_band_region(int16_t *jf, int16_t *pf, int m1, int comp,
                           int r0, int r1_, int c0, int c1)
{
    int r;
    for (r = r0; r < r1_; r++) {
        long base = (long)r * D;
        int j = c0;
        while (j < c1) {
            long i = base + j;
            int a = pf[i];
            if ((a == -7 || a == -8) && !comp) {
                if (j < 127 && (pf[i + 1] == -7 || pf[i + 1] == -8)) {
                    jf[i] = -11;
                    jf[i + 1] = -11;
                    j += 2;
                    continue;
                }
            }
            if (a < 0) {
                int nxt = (i + 1 < SZ) ? pf[i + 1] : 0;
                a = -a;
                if (nxt > -8 && nxt < 0) {
                    if ((a & 7) < 6) a &= 65528;
                } else {
                    if ((a & 7) < 7) a &= 65528;
                }
                a = -a;
            }
            if (a > -m1 && a < m1) { jf[i] = 0; j += 1; continue; }
            a += 128;
            if (a < 0) a = -((-a) & 65528);
            else a &= 65528;
            jf[i] = (int16_t)(a > 128 ? a - 125 : a - 131);
            j += 1;
        }
    }
}

void nhw_offset_uv_recons256(int16_t *jf, int16_t *pf, int low5p, int m1,
                             int comp)
{
    long i;
    if (comp) {
        if (low5p) {
            i = 0;
            while (i < (SZ >> 2)) {
                if ((i & 255) < 64) {
                    if (!(i >> 8)) {
                        jf[i] = pf[i];
                        jf[i + 1] = (int16_t)(pf[i + 1] & 65534);
                    } else {
                        jf[i] = (int16_t)(pf[i] & 65534);
                        jf[i + 1] = pf[i + 1];
                    }
                    i += 1;
                }
                i += 1;
            }
        } else {
            for (i = 0; i < (SZ >> 2); i++)
                if ((i & 255) < 64)
                    jf[i] = (int16_t)((pf[i] & 65532) + 1);
        }
    } else {
        for (i = 0; i < (SZ >> 2); i++) {
            if ((i & 255) < 64) {
                int v = pf[i];
                jf[i] = (v > 0 && v < 256) ? (int16_t)(v & 65534) : pf[i];
            }
        }
    }
    uv_band_region(jf, pf, m1, comp, 0, 64, 64, 128);
    uv_band_region(jf, pf, m1, comp, 64, 128, 0, 128);
}

/* ------------------------------------------------------------------ */
/* LL2 plane -> byte codes + escapes + parity runs
 * (ops/ll2.py ll2_code_y; encoder/nhw_encoder.c:636-743)              */

void nhw_ll2_code_y(int16_t *pf, uint8_t *tree1, uint8_t *ch_res,
                    int32_t *exw, long *n_exw,
                    int32_t *res4, long *n_res4, int low3p)
{
    long ne = 0, nr = 0, a_out = 0;
    int r, j;

    if (low3p) {
        for (r = 0; r < 128; r++) {
            long base = (long)r * N;
            j = 0;
            while (j < 125) {
                long a = base + j;
                int d = pf[a] - pf[a + 3];
                if ((pf[a] & 1) && (pf[a + 1] & 1) && (pf[a + 2] & 1)
                        && (pf[a + 3] & 1) && (d > 1 || d < -1)) {
                    pf[a] += 24000; pf[a + 1] += 16000;
                    pf[a + 2] += 16000; pf[a + 3] += 16000;
                    j += 4;
                } else j += 1;
            }
        }
    }

    for (r = 0; r < 128; r++) {
        long base = (long)r * N;
        int stage = 0;
        for (j = 0; j < 128; j++) {
            long cnt = base + j;
            int scan = pf[cnt];

            if (low3p && scan > 10000) {
                if (scan > 20000) {
                    scan -= 24000;
                    res4[nr++] = j + 1;
                    stage += 1;
                } else scan -= 16000;
            } else if ((scan & 1) && j > 0 && (pf[cnt + 1] & 1)) {
                if (j < 126 && (pf[cnt + 2] & 1)) {
                    int d = scan - pf[cnt + 2];
                    if ((d > 1 || d < -1) && low3p) pf[cnt + 1] += 1;
                } else if (base < SZ - N - 2 && (pf[cnt + N] & 1)
                           && (pf[cnt + N + 1] & 1)
                           && !(pf[cnt + N + 2] & 1)) {
                    if (pf[cnt + N] < 10000 && low3p) pf[cnt + N] += 1;
                }
            } else if ((scan & 1) && base >= N && base < SZ - 3 * N) {
                if ((pf[cnt + N] & 1) && (pf[cnt + N + 1] & 1)) {
                    if ((pf[cnt + 2 * N] & 1) && !(pf[cnt + 3 * N] & 1)) {
                        if (pf[cnt + N] < 10000 && low3p) pf[cnt + N] += 1;
                    }
                }
            }

            if (scan > 255 && (j > 0 || r > 0)) {
                exw[ne++] = r;
                exw[ne++] = j + 128;
                exw[ne++] = scan - 255 < 255 ? scan - 255 : 255;
                tree1[a_out] = tree1[a_out - 1];
                ch_res[a_out] = tree1[a_out - 1];
                a_out++;
                pf[cnt] = 0;
            } else if (scan < 0 && (j > 0 || r > 0)) {
                exw[ne++] = r;
                exw[ne++] = j;
                exw[ne++] = -(scan > -255 ? scan : -255);
                tree1[a_out] = tree1[a_out - 1];
                ch_res[a_out] = tree1[a_out - 1];
                a_out++;
                pf[cnt] = 0;
            } else {
                scan = scan > 255 ? 255 : (scan < 0 ? 0 : scan);
                ch_res[a_out] = (uint8_t)scan;
                tree1[a_out] = (uint8_t)(scan & 254);
                a_out++;
                pf[cnt] = 0;
            }
        }
        if (low3p) {
            if (!stage) res4[nr++] = 128;
            else res4[nr - 1] += 128;
        }
    }
    *n_exw = ne;
    *n_res4 = nr;
}

/* ------------------------------------------------------------------ */
/* Y_highres_compression (ops/ll2.py; encoder/compress_pixel.c:471-876)
 * h: int32 tree1 + aliased tail, h_len entries.                       */

static long yhr_escape(int32_t *ch, long *nc, const int32_t *h,
                       const uint8_t *ch_res, int32_t *hr_word,
                       long *nhw_, int32_t *hr_mem, long *nhm,
                       long i, int low5p)
{
    if (low5p) {
        ch[(*nc)++] = 128;
        ch[(*nc)++] = 128 + (h[i] >> 1);
        ch[(*nc)++] = 128 + (h[i + 1] >> 1);
        hr_word[(*nhw_)++] = ch_res[i];
        hr_mem[(*nhm)++] = (int32_t)i;
        return i + 1;
    }
    ch[(*nc)++] = 128;
    ch[(*nc)++] = 128 + (h[i] >> 1);
    return i;
}

void nhw_y_highres_compression(const int32_t *h, long h_len,
                               const uint8_t *ch_res, int low5p,
                               int32_t *out, long *n_out, int *res_low_out,
                               int32_t *hr_word, long *n_hr_word,
                               int32_t *hr_mem, long *n_hr_mem)
{
    /* thread-local scratch (threaded pipeline — see nhw_offset_y) */
    static __thread int32_t ch[3 * 16384 + 8];
    long nc = 0, nhw_ = 0, nhm = 0, i, j, o;
    long e = 0, Y = 0, a = 0, cap = h_len - 1;
    int res_low;

    i = 1;
    while (i < 16384) {
        while (i < cap && h[i] == h[i - 1]) {
            e += 1;
            if (e < 16) {
                if (e == 8) a += 1;
                i += 1;
            } else if (e == 16) { Y += 1; break; }
        }
        e = 0;
        i += 1;
    }
    a += Y;

    ch[nc++] = h[0];
    if (Y > 299) res_low = 2;
    else if (a > 179) res_low = 1;
    else res_low = 0;

    if (res_low == 0) {
        i = 1; a = 0;
        while (i < 16384) {
            int scan = h[i] - h[i - 1];
            int count = h[i + 1] - h[i];
            if (scan == 0 && count == 0) {
                long code;
                int d1, d2;
                if (h[i + a + 2] == h[i + a + 1]) a += 1;
                i += a + 2;
                code = a << 3;
                d1 = h[i] - h[i - 1];
                d2 = h[i + 1] - h[i];
                if (d1 == 2) {
                    if (d2 == -2) { code += 2; i += 1; }
                    else if (d2 == 0) { code += 3; i += 1; }
                    else code += 1;
                } else if (d1 == -2) {
                    if (d2 == 2) { code += 4; i += 1; }
                    else if (d2 == 0) { code += 5; i += 1; }
                    else code += 6;
                } else if (d1 == 4) code += 7;
                else i -= 1;
                ch[nc++] = (int32_t)code;
                a = 0;
                i += 1;
                continue;
            }
            if (iabs(scan) <= 6 && iabs(count) <= 8) {
                int s = scan + 6, c = count + 8;
                if (s == 12 || c == 16) {
                    if (i < 16382 && iabs(h[i + 2] - h[i + 1]) <= 32) {
                        int e3 = h[i + 2] - h[i + 1] + 32;
                        s += 26; c += 8;
                        if (s == 64 || c == 32 || e3 == 64)
                            i = yhr_escape(ch, &nc, h, ch_res, hr_word,
                                           &nhw_, hr_mem, &nhm, i, low5p);
                        else {
                            c >>= 1;
                            ch[nc++] = 64;
                            ch[nc++] = 64 + s + (c >> 3);
                            ch[nc++] = ((c & 7) << 5) + (e3 >> 1);
                            i += 2;
                        }
                    } else
                        i = yhr_escape(ch, &nc, h, ch_res, hr_word, &nhw_,
                                       hr_mem, &nhm, i, low5p);
                } else {
                    if (s < 8) ch[nc++] = 32 + (s << 2) + (c >> 1);
                    else if (s == 8) ch[nc++] = 16 + (c >> 1);
                    else ch[nc++] = 24 + (c >> 1);
                    i += 1;
                }
            } else if (iabs(scan) <= 32 && iabs(count) <= 16 && i < 16382
                       && iabs(h[i + 2] - h[i + 1]) <= 32) {
                int s = scan + 32, c = count + 16;
                int e3 = h[i + 2] - h[i + 1] + 32;
                if (s == 64 || c == 32 || e3 == 64)
                    i = yhr_escape(ch, &nc, h, ch_res, hr_word, &nhw_,
                                   hr_mem, &nhm, i, low5p);
                else {
                    c >>= 1;
                    ch[nc++] = 64;
                    ch[nc++] = 64 + s + (c >> 3);
                    ch[nc++] = ((c & 7) << 5) + (e3 >> 1);
                    i += 2;
                }
            } else
                i = yhr_escape(ch, &nc, h, ch_res, hr_word, &nhw_, hr_mem,
                               &nhm, i, low5p);
            i += 1;
        }
    } else if (res_low == 1) {
        i = 1; a = 0;
        while (i < 16384) {
            int scan = h[i] - h[i - 1];
            int count = h[i + 1] - h[i];
            if (scan == 0 && count == 0) {
                long code;
                int d1;
                while (a < 7 && h[i + a + 2] == h[i + a + 1]) a += 1;
                i += a + 2;
                code = a << 2;
                d1 = h[i] - h[i - 1];
                if (d1 == 2) code += 1;
                else if (d1 == -2) code += 2;
                else if (d1 == 0) code += 3;
                else i -= 1;
                ch[nc++] = (int32_t)code;
                a = 0;
                i += 1;
                continue;
            }
            if (iabs(scan) <= 4 && iabs(count) <= 8) {
                int s = scan + 4, c = count + 8;
                if (s == 8 || c == 16) {
                    if (i < 16382 && iabs(h[i + 2] - h[i + 1]) <= 32) {
                        int e3 = h[i + 2] - h[i + 1] + 32;
                        s += 28; c += 8;
                        if (s == 64 || c == 32 || e3 == 64)
                            i = yhr_escape(ch, &nc, h, ch_res, hr_word,
                                           &nhw_, hr_mem, &nhm, i, low5p);
                        else {
                            c >>= 1;
                            ch[nc++] = 64;
                            ch[nc++] = 64 + s + (c >> 3);
                            ch[nc++] = ((c & 7) << 5) + (e3 >> 1);
                            i += 2;
                        }
                    } else
                        i = yhr_escape(ch, &nc, h, ch_res, hr_word, &nhw_,
                                       hr_mem, &nhm, i, low5p);
                } else {
                    ch[nc++] = 32 + (s << 2) + (c >> 1);
                    i += 1;
                }
            } else if (iabs(scan) <= 32 && iabs(count) <= 16 && i < 16382
                       && iabs(h[i + 2] - h[i + 1]) <= 32) {
                int s = scan + 32, c = count + 16;
                int e3 = h[i + 2] - h[i + 1] + 32;
                if (s == 64 || c == 32 || e3 == 64)
                    i = yhr_escape(ch, &nc, h, ch_res, hr_word, &nhw_,
                                   hr_mem, &nhm, i, low5p);
                else {
                    c >>= 1;
                    ch[nc++] = 64;
                    ch[nc++] = 64 + s + (c >> 3);
                    ch[nc++] = ((c & 7) << 5) + (e3 >> 1);
                    i += 2;
                }
            } else
                i = yhr_escape(ch, &nc, h, ch_res, hr_word, &nhw_, hr_mem,
                               &nhm, i, low5p);
            i += 1;
        }
    } else {
        i = 1; a = 0;
        while (i < 16384) {
            int scan = h[i] - h[i - 1];
            int count = h[i + 1] - h[i];
            if (scan == 0 && count == 0) {
                while (a < 63 && h[i + a + 2] == h[i + a + 1]) a += 1;
                i += a + 1;
                ch[nc++] = (int32_t)a;
                a = 0;
                i += 1;
                continue;
            }
            if (iabs(scan) <= 32 && iabs(count) <= 16 && i < 16382
                && iabs(h[i + 2] - h[i + 1]) <= 32) {
                int s = scan + 32, c = count + 16;
                int e3 = h[i + 2] - h[i + 1] + 32;
                if (s == 64 || c == 32 || e3 == 64)
                    i = yhr_escape(ch, &nc, h, ch_res, hr_word, &nhw_,
                                   hr_mem, &nhm, i, low5p);
                else {
                    c >>= 1;
                    ch[nc++] = 64;
                    ch[nc++] = 64 + s + (c >> 3);
                    ch[nc++] = ((c & 7) << 5) + (e3 >> 1);
                    i += 2;
                }
            } else
                i = yhr_escape(ch, &nc, h, ch_res, hr_word, &nhw_, hr_mem,
                               &nhm, i, low5p);
            i += 1;
        }
    }

    /* squeeze pass (compress_pixel.c:838-866) */
    j = nc;
    o = 0;
    out[o++] = ch[0];
    i = 1;
    while (i < j - 1) {
        if (ch[i] == 64) {
            out[o++] = ch[i + 1];
            out[o++] = ch[i + 2];
            i += 2;
        } else if (ch[i] == 128) {
            if (low5p) {
                out[o++] = ch[i + 2];
                i += 2;
            } else {
                i += 1;
                out[o++] = ch[i];
            }
        } else out[o++] = ch[i];
        i += 1;
    }
    if (i < j) out[o++] = ch[j - 1];

    *n_out = o;
    *res_low_out = res_low;
    *n_hr_word = nhw_;
    *n_hr_mem = nhm;
}

/* ------------------------------------------------------------------ */
/* YUV->RGB with per-quality float semantics
 * (models/decoder.py yuv_to_rgb; decoder/nhw_decoder_cli.c:133-283).
 * mode 0: q>=NORM double path; 1: LOW3 scaled-sum; 2: LOW1/2 float32
 * Y prescale; 3: q<=LOW4 integer matrix.  No FMA contraction at the
 * default x86-64 codegen, so float32/float64 roundings match numpy.  */

static uint8_t rgb_clip(long v)
{
    if (v >> 8) return v < 0 ? 0 : 255;
    return (uint8_t)v;
}

void nhw_yuv_to_rgb(const uint8_t *y, const uint8_t *u, const uint8_t *v,
                    uint8_t *out, int mode, float yinv,
                    int rc, int gc, int bc)
{
    long i;
    if (mode == 3) {
        for (i = 0; i < (long)N * N; i++) {
            long yi = (long)y[i] * 298;
            long ui = u[i], vi = v[i];
            long ra = yi + 409 * vi + rc;
            long ga = yi - 100 * ui - 208 * vi + gc;
            long ba = yi + 516 * ui + bc;
            float fr = (float)ra * yinv + 128.5f;
            float fg = (float)ga * yinv + 128.5f;
            float fb = (float)ba * yinv + 128.5f;
            out[3 * i] = rgb_clip((long)fr >> 8);
            out[3 * i + 1] = rgb_clip((long)fg >> 8);
            out[3 * i + 2] = rgb_clip((long)fb >> 8);
        }
        return;
    }
    for (i = 0; i < (long)N * N; i++) {
        double uf = (double)u[i] - 128.0;
        double vf = (double)v[i] - 128.0;
        double yq, r, g, b;
        if (mode == 2) yq = (double)((float)y[i] * yinv);
        else yq = (double)y[i];
        if (mode == 1) {
            double yd = (double)yinv;
            r = (yq + 1.402 * vf) * yd + 0.5;
            g = (yq - 0.34414 * uf - 0.71414 * vf) * yd + 0.5;
            b = (yq + 1.772 * uf) * yd + 0.5;
        } else {
            r = yq + 1.402 * vf + 0.5;
            g = yq - 0.34414 * uf - 0.71414 * vf + 0.5;
            b = yq + 1.772 * uf + 0.5;
        }
        out[3 * i] = rgb_clip((long)r);
        out[3 * i + 1] = rgb_clip((long)g);
        out[3 * i + 2] = rgb_clip((long)b);
    }
}

/* ------------------------------------------------------------------ */
/* UV 64x64 LL2 plane compression (ops/ll2.py uv_highres_compression;
 * encoder/compress_pixel.c:878-1014).  h: 8192 masked bytes + tail.   */

void nhw_uv_highres_compression(const int32_t *h, int32_t *out, long *n_out)
{
    const long n = 8192;
    long o = 0, i = 1, a = 0;
    int res = 0;
    out[o++] = h[0];
    while (i < n) {
        int scan = h[i] - h[i - 1];
        int count = h[i + 1] - h[i];
        if (scan == 0 && count == 0) {
            while (h[i + a + 2] == h[i + a + 1]) {
                a += 1;
                if (a < 7) continue;
                if (a == 7 || res == 1) {
                    res = 1;
                    if (a < 14) continue;
                }
                break;
            }
            i += a + 1;
            if (res == 1) out[o++] = (int32_t)(64 + (7 << 3) + a - 7);
            else {
                long code;
                int d1, d2, d3;
                i += 1;
                code = 64 + (a << 3);
                d1 = h[i] - h[i - 1];
                d2 = h[i + 1] - h[i];
                d3 = h[i + 2] - h[i + 1];
                if (d1 == 4) {
                    if (d2 == -4) {
                        if (d3 == 0) { code += 3; i += 2; }
                        else { code += 2; i += 1; }
                    } else code += 1;
                } else if (d1 == -4) {
                    if (d2 == 4) {
                        if (d3 == 0) { code += 4; i += 2; }
                        else { code += 5; i += 1; }
                    } else code += 6;
                } else if (d1 == 8) code += 7;
                else i -= 1;
                out[o++] = (int32_t)code;
            }
            a = 0;
            res = 0;
            i += 1;
            continue;
        }
        if (iabs(scan) <= 4 && iabs(count) <= 4) {
            int d3;
            if (scan == 0 && count == 4) res = 0;
            else if (scan == 0 && count == -4) res = 1;
            else if (scan == 4 && count == 0) res = 2;
            else if (scan == -4 && count == 0) res = 3;
            else if (scan == 4 && count == 4) res = 4;
            else if (scan == 4 && count == -4) res = 5;
            else if (scan == -4 && count == 4) res = 6;
            else if (scan == -4 && count == -4) res = 7;
            d3 = h[i + 2] - h[i + 1];
            if (d3 == 0) { out[o++] = 128 + 64 + (res << 2); i += 2; }
            else if (d3 == 4) { out[o++] = 128 + 64 + (res << 2) + 1; i += 2; }
            else if (d3 == -4) { out[o++] = 128 + 64 + (res << 2) + 2; i += 2; }
            else if (d3 == 8) { out[o++] = 128 + 64 + (res << 2) + 3; i += 2; }
            else {
                out[o++] = ((scan + 16) << 1) + ((count + 16) >> 2);
                i += 1;
            }
            res = 0;
        } else if (iabs(scan) <= 16 && iabs(count) <= 16) {
            int s = scan + 16, c = count + 16;
            if (s == 32 || c == 32) out[o++] = 128 + (h[i] >> 2);
            else { out[o++] = (s << 1) + (c >> 2); i += 1; }
        } else out[o++] = 128 + (h[i] >> 2);
        i += 1;
    }
    *n_out = o;
}

/* ------------------------------------------------------------------ */
/* Encoder colorspace: RGB -> YUV420 (ops/colorspace.py downsample_yuv420;
 * encoder/colorspace.c:55-260).  mode 0: q>=NORM; 1: LOW1/2 (yq f32);
 * 2: LOW3 (0.94 scaling); 3: q<=LOW4 integer matrix with qtz.         */

static void chroma_downsample(const uint8_t *c, uint8_t *out)
{
    /* thread-local scratch (threaded pipeline — see nhw_offset_y) */
    static __thread int32_t h[512][256];
    int r, j;
    for (r = 0; r < 512; r++) {
        const uint8_t *row = c + (long)r * 512;
        h[r][0] = (row[0] + row[1] + 1) >> 1;
        for (j = 1; j < 256; j++)
            h[r][j] = (row[2 * j - 1] + 2 * row[2 * j] + row[2 * j + 1]
                       + 2) >> 2;
    }
    for (j = 0; j < 256; j++)
        out[j] = (uint8_t)((h[0][j] + h[1][j] + 1) >> 1);
    for (r = 1; r < 256; r++)
        for (j = 0; j < 256; j++)
            out[(long)r * 256 + j] = (uint8_t)(
                (h[2 * r - 1][j] + 2 * h[2 * r][j] + h[2 * r + 1][j] + 2)
                >> 2);
}

static uint8_t u8_clip_c(long v)
{
    if (v >> 8) return v < 0 ? 0 : 255;
    return (uint8_t)v;
}

void nhw_downsample_yuv420(const uint8_t *rgb, int mode, float yq, int qtz,
                           int16_t *y, uint8_t *u_out, uint8_t *v_out)
{
    /* Per-mode loops written as branchless elementwise code over a
     * row-sized scratch so the compiler vectorizes the float math
     * (4-wide double on AVX2); per-element operation order is
     * unchanged, so results stay bit-identical to the scalar form. */
    /* thread-local scratch (threaded pipeline — see nhw_offset_y) */
    static __thread uint8_t uplane[512 * 512], vplane[512 * 512];
    long i, r0;
    if (mode == 3) {
        for (i = 0; i < 512L * 512; i++) {
            int ri = rgb[3 * i], gi = rgb[3 * i + 1], bi = rgb[3 * i + 2];
            long yv = (((66L * ri + 129L * gi + 25L * bi) * qtz + 4194304)
                       >> 23) + 16;
            long uv = (((-38L * ri - 74L * gi + 112L * bi) * qtz + 4194304)
                       >> 23) + 128;
            long vv = (((112L * ri - 94L * gi - 18L * bi) * qtz + 4194304)
                       >> 23) + 128;
            y[i] = (int16_t)yv;
            uplane[i] = u8_clip_c(uv);
            vplane[i] = u8_clip_c(vv);
        }
    } else {
        double rr[512], gg[512], bb[512];
        double yv[512], cb[512], cr[512];
        double ymul = mode == 1 ? (double)yq : (mode == 2 ? 0.94 : 1.0);
        for (r0 = 0; r0 < 512L * 512; r0 += 512) {
            const uint8_t *px = rgb + 3 * r0;
            for (i = 0; i < 512; i++) {
                rr[i] = (double)px[3 * i];
                gg[i] = (double)px[3 * i + 1];
                bb[i] = (double)px[3 * i + 2];
            }
            for (i = 0; i < 512; i++) {
                double ysum = 0.299 * rr[i] + 0.587 * gg[i]
                              + 0.114 * bb[i];
                cb[i] = -0.1687 * rr[i] - 0.3313 * gg[i] + 0.5 * bb[i];
                cr[i] = 0.5 * rr[i] - 0.4187 * gg[i] - 0.0813 * bb[i];
                yv[i] = mode == 0 ? ysum + 0.5 : ysum * ymul + 0.5;
                if (mode == 2) { cb[i] *= 0.94; cr[i] *= 0.94; }
            }
            for (i = 0; i < 512; i++) {
                /* the reference's color_balance is a float: the double
                 * sum rounds to float32, then the +-half add runs in
                 * float32 (encoder/colorspace.c:60,75-81) */
                float cbf = (float)cb[i], crf = (float)cr[i];
                long uv = (long)(cbf >= 0 ? cbf + 128.5f : cbf + 128.4f);
                long vv = (long)(crf >= 0 ? crf + 128.5f : crf + 128.4f);
                y[r0 + i] = (int16_t)(long)yv[i];
                uplane[r0 + i] = u8_clip_c(uv);
                vplane[r0 + i] = u8_clip_c(vv);
            }
        }
    }
    chroma_downsample(uplane, u_out);
    chroma_downsample(vplane, v_out);
}

/* ------------------------------------------------------------------ */
/* Integer 5/3 lifting filter row passes (ops/lifting.py synth_unnorm /
 * synth_norm, ops/analysis.py down_iv / down_53 / down_vi; reference
 * encoder/filters.c:55-386, decoder/filters.c:143-194).  All inputs are
 * int16 rows; stores wrap to int16 exactly where the C reference stores
 * into short.                                                         */

static int w16(int x) { return (int16_t)x; }

void nhw_synth_unnorm(const int16_t *L, const int16_t *H, long rows, long M,
                      int32_t *out)
{
    long r, k;
    for (r = 0; r < rows; r++) {
        const int16_t *l = L + r * M, *h = H + r * M;
        int32_t *o = out + r * 2 * M;
        for (k = 0; k < M; k++) {
            int even = w16(k < M - 1 ? l[k] << 3 : l[M - 1] << 3);
            int odd = w16(k < M - 1 ? (l[k + 1] + l[k]) << 2
                                    : l[M - 1] << 3);
            int sub = k == 0 ? h[0] << 2 : (h[k] + h[k - 1]) << 1;
            int add;
            if (k == 0) add = 5 * h[0] - h[1];
            else if (k == M - 1) add = 5 * h[M - 1] - h[M - 2];
            else add = 6 * h[k] - h[k + 1] - h[k - 1];
            o[2 * k] = w16(even - sub);
            o[2 * k + 1] = w16(odd + add);
        }
    }
}

void nhw_synth_norm(const int16_t *L, const int16_t *H, long rows, long M,
                    int32_t *out)
{
    long r, k;
    for (r = 0; r < rows; r++) {
        const int16_t *l = L + r * M, *h = H + r * M;
        int32_t *o = out + r * 2 * M;
        for (k = 0; k < M; k++) {
            int even = w16(k < M - 1 ? l[k] << 3 : l[M - 1] << 3);
            int odd = w16(k < M - 1 ? (l[k + 1] + l[k]) << 2
                                    : l[M - 1] << 3);
            int sub = k == 0 ? h[0] << 2 : (h[k] + h[k - 1]) << 1;
            int add;
            if (k == 0) add = 5 * h[0] - h[1];
            else if (k == M - 1) add = 5 * h[M - 1] - h[M - 2];
            else add = 6 * h[k] - h[k + 1] - h[k - 1];
            even = w16(even - sub);
            odd = w16(odd + add);
            o[2 * k] = w16(even > 0 ? even + 32 : even) >> 6;
            o[2 * k + 1] = w16(odd > 0 ? odd + 32 : odd) >> 6;
        }
    }
}

static int round_pos(int r, int add, int shift)
{
    return r >= 0 ? (r + add) >> shift : -((-r + add) >> shift);
}

void nhw_down_iv(const int16_t *X, long rows, long n,
                 int16_t *low, int16_t *high)
{
    /* edge cases peeled; the middle loops are pure stencils the
     * compiler vectorizes (identical per-element integer math) */
    long r, k, M = n >> 1;
    for (r = 0; r < rows; r++) {
        const int16_t *x = X + r * n;
        int16_t *lo = low + r * M, *hi = high + r * M;
        lo[0] = (int16_t)(6 * x[0] + 4 * x[1] - 2 * x[2]);
        for (k = 1; k < M - 1; k++)
            lo[k] = (int16_t)(6 * x[2 * k]
                              + 2 * (x[2 * k - 1] + x[2 * k + 1])
                              - (x[2 * k - 2] + x[2 * k + 2]));
        lo[M - 1] = (int16_t)(6 * x[n - 2] + 2 * (x[n - 3] + x[n - 1])
                              - (x[n - 4] + x[n - 2]));
        for (k = 0; k < M - 1; k++)
            hi[k] = (int16_t)(2 * x[2 * k + 1]
                              - (x[2 * k] + x[2 * k + 2]));
        hi[M - 1] = (int16_t)((x[n - 1] - x[n - 2]) << 1);
    }
}

void nhw_down_53(const int16_t *X, long rows, long n,
                 int16_t *low, int16_t *high)
{
    /* the prev_odd "carry" is just the previous a[] entry's low bit,
     * so the highpass splits into two vectorizable passes over a[] */
    long r, k, M = n >> 1;
    int a[256];
    for (r = 0; r < rows; r++) {
        const int16_t *x = X + r * n;
        int16_t *lo = low + r * M, *hi = high + r * M;
        lo[0] = (int16_t)round_pos(6 * x[0] + 4 * x[1] - 2 * x[2], 8, 4);
        for (k = 1; k < M - 1; k++)
            lo[k] = (int16_t)round_pos(
                6 * x[2 * k] + 2 * (x[2 * k - 1] + x[2 * k + 1])
                - (x[2 * k - 2] + x[2 * k + 2]), 8, 4);
        lo[M - 1] = (int16_t)round_pos(
            6 * x[n - 2] + 2 * (x[n - 3] + x[n - 1])
            - (x[n - 4] + x[n - 2]), 8, 4);
        for (k = 0; k < M - 1; k++)
            a[k] = x[2 * k] + x[2 * k + 2];
        for (k = 0; k < M - 1; k++) {
            int prev = k ? (a[k - 1] & 1) : 0;
            int adj = a[k] + ((a[k] & 1) & prev & (int)(k & 1));
            int rh = x[2 * k + 1] - (adj >> 1);
            hi[k] = (int16_t)(rh > 0 ? (rh + 1) >> 1 : rh >> 1);
        }
        hi[M - 1] = (int16_t)((x[n - 1] - x[n - 2] + 1) >> 1);
    }
}

void nhw_down_vi(const int16_t *X, long rows, long n,
                 int16_t *low, int16_t *high)
{
    /* the dither "carry" d_prev depends only on the raw moment at the
     * previous slot, so the pass splits into vectorizable stages:
     * raw moments rr[], per-slot dither d[], then lo from rr[k]+d[k-1] */
    long r, k, M = n >> 1;
    int rr[256], d[256], a[256];
    for (r = 0; r < rows; r++) {
        const int16_t *x = X + r * n;
        int16_t *lo = low + r * M, *hi = high + r * M;
        rr[0] = 6 * x[0] + 4 * x[1] - 2 * x[2];
        for (k = 1; k < M - 1; k++)
            rr[k] = 6 * x[2 * k] + 2 * (x[2 * k - 1] + x[2 * k + 1])
                    - (x[2 * k - 2] + x[2 * k + 2]);
        rr[M - 1] = 6 * x[n - 2] + 2 * (x[n - 3] + x[n - 1])
                    - (x[n - 4] + x[n - 2]);
        for (k = 0; k < M; k++) {
            int rm = (rr[k] < 0 ? -rr[k] : rr[k]) & 63;
            int mag = rm < 32 ? rm >> 2 : -((64 - rm) >> 2);
            d[k] = rr[k] >= 0 ? mag : -mag;
        }
        lo[0] = (int16_t)round_pos(w16(rr[0]), 32, 6);
        for (k = 1; k < M; k++)
            lo[k] = (int16_t)round_pos(w16(rr[k] + d[k - 1]), 32, 6);
        for (k = 0; k < M - 1; k++)
            a[k] = x[2 * k] + x[2 * k + 2];
        for (k = 0; k < M - 1; k++) {
            int prev = k ? (a[k - 1] & 1) : 0;
            int adj = a[k] + ((a[k] & 1) & prev & (int)(k & 1));
            int rh = x[2 * k + 1] - (adj >> 1);
            hi[k] = (int16_t)round_pos(rh, 4, 3);
        }
        hi[M - 1] = (int16_t)(w16(x[n - 1] - x[n - 2]) >> 3);
    }
}

/* ------------------------------------------------------------------ */
/* LL2 DC-plane reconstruction (ops/dc_plane.py decode_dc_planes;
 * decoder/nhw_decoder.c:1665-1979).  Fills rc[49153]; the U/V LSB
 * bit-planes are re-added by the caller.                              */

static long dc3byte(const uint8_t *ch, long i, uint8_t *rc, long j)
{
    int c = ch[i] - 64, t;
    rc[j] = (uint8_t)(((((c >> 1) & 31) << 1) - 32 + rc[j - 1]) & 255);
    t = (c & 1) << 3;
    i += 1;
    t |= ch[i] >> 5;
    rc[j + 1] = (uint8_t)(((t << 1) - 16 + rc[j]) & 255);
    rc[j + 2] = (uint8_t)((((ch[i] & 31) << 1) - 32 + rc[j + 1]) & 255);
    return i;
}

int nhw_decode_dc_planes(const uint8_t *ch, const uint8_t *hr,
                         const int32_t *uv_off, int use_hr, int mode,
                         uint8_t *rc, long n_ch, long n_hr)
{
    const long Y_LL2 = 16384;
    long i = 1, a = 0, j = 1, end;
    int k_, run, low, c, v;
    if (n_ch < 1) return -1;
    rc[0] = ch[0];

    if (mode == 0) {
        while (j < Y_LL2) {
            if (i >= n_ch) return -1;
            c = ch[i];
            if (c >= 128) {
                if (use_hr) {
                    if (a >= n_hr) return -1;
                    rc[j] = hr[a]; j += 1; a += 1;
                }
                rc[j] = (uint8_t)(((c - 128) << 1) & 255);
                j += 1;
            } else if (c < 16) {
                run = (c >> 3) & 1;
                v = rc[j - 1];
                for (k_ = 0; k_ < run + 2; k_++) { rc[j] = v; j += 1; }
                low = c & 7;
                if (low == 1) { rc[j] = rc[j - 1] + 2; j += 1; }
                else if (low == 2) {
                    rc[j] = rc[j - 1] + 2; j += 1;
                    rc[j] = rc[j - 1] - 2; j += 1;
                } else if (low == 3) {
                    rc[j] = rc[j - 1] + 2; j += 1;
                    rc[j] = rc[j - 1]; j += 1;
                } else if (low == 4) {
                    rc[j] = rc[j - 1] - 2; j += 1;
                    rc[j] = rc[j - 1] + 2; j += 1;
                } else if (low == 5) {
                    rc[j] = rc[j - 1] - 2; j += 1;
                    rc[j] = rc[j - 1]; j += 1;
                } else if (low == 6) { rc[j] = rc[j - 1] - 2; j += 1; }
                else if (low == 7) { rc[j] = rc[j - 1] + 4; j += 1; }
            } else if (c < 32) {
                rc[j] = rc[j - 1] + (c >= 24 ? 4 : 2);
                j += 1;
                rc[j] = (uint8_t)((((c & 7) << 1) - 8 + rc[j - 1]) & 255);
                j += 1;
            } else if (c < 64) {
                c -= 32;
                rc[j] = (uint8_t)((((c >> 3) << 1) - 6 + rc[j - 1]) & 255);
                j += 1;
                rc[j] = (uint8_t)((((c & 7) << 1) - 8 + rc[j - 1]) & 255);
                j += 1;
            } else {
                if (i + 1 >= n_ch) return -1;
                i = dc3byte(ch, i, rc, j); j += 3;
            }
            i += 1;
        }
    } else if (mode == 1) {
        while (j < Y_LL2) {
            if (i >= n_ch) return -1;
            c = ch[i];
            if (c >= 128) {
                if (use_hr) {
                    if (a >= n_hr) return -1;
                    rc[j] = hr[a]; j += 1; a += 1;
                }
                rc[j] = (uint8_t)(((c - 128) << 1) & 255);
                j += 1;
            } else if (c < 32) {
                run = (c >> 2) & 7;
                v = rc[j - 1];
                for (k_ = 0; k_ < run + 2; k_++) { rc[j] = v; j += 1; }
                low = c & 3;
                if (low == 1) { rc[j] = rc[j - 1] + 2; j += 1; }
                else if (low == 2) { rc[j] = rc[j - 1] - 2; j += 1; }
                else if (low == 3) { rc[j] = rc[j - 1]; j += 1; }
            } else if (c < 64) {
                c -= 32;
                rc[j] = (uint8_t)((((c >> 3) << 1) - 4 + rc[j - 1]) & 255);
                j += 1;
                rc[j] = (uint8_t)((((c & 7) << 1) - 8 + rc[j - 1]) & 255);
                j += 1;
            } else {
                if (i + 1 >= n_ch) return -1;
                i = dc3byte(ch, i, rc, j); j += 3;
            }
            i += 1;
        }
    } else {
        while (j < Y_LL2) {
            if (i >= n_ch) return -1;
            c = ch[i];
            if (c >= 128) {
                if (use_hr) {
                    if (a >= n_hr) return -1;
                    rc[j] = hr[a]; j += 1; a += 1;
                }
                rc[j] = (uint8_t)(((c - 128) << 1) & 255);
                j += 1;
            } else if (c < 64) {
                run = c & 63;
                v = rc[j - 1];
                for (k_ = 0; k_ < run + 2; k_++) { rc[j] = v; j += 1; }
            } else {
                if (i + 1 >= n_ch) return -1;
                i = dc3byte(ch, i, rc, j); j += 3;
            }
            i += 1;
        }
    }

    if (i >= n_ch) return -1;
    rc[Y_LL2] = ch[i];
    i += 1;

    j = Y_LL2 + 1;
    end = Y_LL2 + 8192;
    while (j < end) {
        if (i >= n_ch) return -1;
        c = ch[i];
        if (c >= 192) {
            c -= 192;
            k_ = c >> 2;
            if (k_ > 7) return -1;  /* uv_off has 8 pairs */
            rc[j] = (uint8_t)((uv_off[2 * k_] + rc[j - 1]) & 255);
            j += 1;
            rc[j] = (uint8_t)((uv_off[2 * k_ + 1] + rc[j - 1]) & 255);
            j += 1;
            low = c & 3;
            if (low == 0) rc[j] = rc[j - 1];
            else if (low == 1) rc[j] = rc[j - 1] + 4;
            else if (low == 2) rc[j] = rc[j - 1] - 4;
            else rc[j] = rc[j - 1] + 8;
            j += 1;
        } else if (c >= 128) {
            rc[j] = (uint8_t)(((c - 128) << 2) & 255);
            j += 1;
        } else if (c >= 64) {
            run = (c >> 3) & 7;
            v = rc[j - 1];
            if (run == 7) {
                run = (c & 7) + 7;
                for (k_ = 0; k_ < run + 2; k_++) { rc[j] = v; j += 1; }
            } else {
                for (k_ = 0; k_ < run + 2; k_++) { rc[j] = v; j += 1; }
                low = c & 7;
                if (low == 1) { rc[j] = rc[j - 1] + 4; j += 1; }
                else if (low == 2) {
                    rc[j] = rc[j - 1] + 4; j += 1;
                    rc[j] = rc[j - 1] - 4; j += 1;
                } else if (low == 3) {
                    rc[j] = rc[j - 1] + 4; j += 1;
                    rc[j] = rc[j - 1] - 4; j += 1;
                    rc[j] = rc[j - 1]; j += 1;
                } else if (low == 4) {
                    rc[j] = rc[j - 1] - 4; j += 1;
                    rc[j] = rc[j - 1] + 4; j += 1;
                    rc[j] = rc[j - 1]; j += 1;
                } else if (low == 5) {
                    rc[j] = rc[j - 1] - 4; j += 1;
                    rc[j] = rc[j - 1] + 4; j += 1;
                } else if (low == 6) { rc[j] = rc[j - 1] - 4; j += 1; }
                else if (low == 7) { rc[j] = rc[j - 1] + 8; j += 1; }
            }
        } else {
            rc[j] = (uint8_t)((((c >> 3) << 2) - 16 + rc[j - 1]) & 255);
            j += 1;
            rc[j] = (uint8_t)((((c & 7) << 2) - 16 + rc[j - 1]) & 255);
            j += 1;
        }
        i += 1;
    }
    return 0;
}

/* ------------------------------------------------------------------ */
/* requant feedback sentinels (ops/requant.py mark_res256 /
 * unmark_res256; encoder/nhw_encoder.c:144-216)                       */

void nhw_mark_res256(const int16_t *process, int16_t *res256)
{
    int r, c;
    for (r = 0; r < D; r++) {
        for (c = 0; c < D; c++) {
            int band = (r >= 128) || (c >= 128);
            long scan = (long)r * N + c;
            int p = process[scan];
            int add = 0;
            if (band) {
                int nmod = (-p) & 7;
                if ((p < -7 && (nmod == 7 || nmod == 0))
                        || (p > 4 && p <= 7))
                    add += 16000;
                else {
                    int a12 = (p < -4 && p >= -7)
                        || (p >= 0 && !(p >= 2 && p < 5)
                            && ((p & 7) == 0 || (p & 7) == 1));
                    if (!a12 && p >= 2 && p < 5
                            && scan >= 2 * D + 1
                            && scan < 2L * SZ - N - 1) {
                        if (process[scan - (N + 1)] != 0
                                || process[scan + (N + 1)] != 0)
                            a12 = 1;
                    }
                    if (a12) add += 12000;
                }
            }
            if (add) res256[(long)r * D + c] += (int16_t)add;
        }
    }
}

void nhw_unmark_res256(int16_t *flat, int16_t *res256)
{
    int r, c;
    for (r = 0; r < D; r++) {
        for (c = 0; c < D; c++) {
            int v = res256[(long)r * D + c];
            long tgt = -1;
            int hi;
            if (v <= 10000) continue;
            hi = v > 14000;
            res256[(long)r * D + c] -= hi ? 16000 : 12000;
            if (r < 128 && c >= 128)
                tgt = ((long)r << 1) + ((long)(c - 128) << 10) + N;
            else if (r >= 128 && c < 128)
                tgt = ((long)(r - 128) << 1) + ((long)c << 10) + 1;
            else if (r >= 128 && c >= 128)
                tgt = ((long)(r - 128) << 1) + ((long)(c - 128) << 10)
                      + N + 1;
            if (tgt >= 0) flat[tgt] += (int16_t)(hi ? 1 : -1);
        }
    }
}

/* ------------------------------------------------------------------ */
/* Y sentinel expansion + band dering nudges
 * (models/decoder.py _expand_sentinels_y; decoder/nhw_decoder.c:493-607) */

static int rd0(const int16_t *flat, long idx)
{
    return (idx >= 0 && idx < 4L * SZ) ? flat[idx] : 0;
}

static void expand_top_c(int16_t *flat, long scan, int j)
{
    int v = flat[scan];
    if (v == 1008) {
        flat[scan - 1] = 5; flat[scan + 1] = 5;
        flat[scan] = j < D ? 5 : 6;
    } else if (v == 1009) {
        flat[scan - 1] = -5; flat[scan + 1] = -5;
        flat[scan] = j < D ? -6 : -7;
    } else if (v == 1010) {
        flat[scan] = 5; flat[scan + 1] = 5;
        flat[scan + N] = 5; flat[scan + N + 1] = 5;
    } else if (v == 1011) {
        flat[scan] = -5; flat[scan + 1] = -5;
        flat[scan + N] = -5; flat[scan + N + 1] = -5;
    } else if (v == 1006) { flat[scan] = -6; flat[scan + 1] = -6; }
    else if (v == 1007) { flat[scan] = 6; flat[scan + 1] = 6; }
}

static void expand_bottom_c(int16_t *flat, long scan)
{
    int v = flat[scan];
    if (v == 1008) {
        flat[scan - 1] = 5; flat[scan] = 6; flat[scan + 1] = 5;
    } else if (v == 1009) {
        flat[scan - 1] = -5; flat[scan] = -7; flat[scan + 1] = -5;
    } else if (v == 1006) {
        if ((scan & 511) < D) { flat[scan] = -7; flat[scan + 1] = -7; }
        else {
            flat[scan - D] = -7; flat[scan - 3 * D] = -7; flat[scan] = 0;
        }
    } else if (v == 1007) {
        if ((scan & 511) < D) { flat[scan] = 7; flat[scan + 1] = 7; }
        else {
            flat[scan - D] = 7; flat[scan - 3 * D] = 7; flat[scan] = 0;
        }
    }
}

void nhw_expand_sentinels_y(int16_t *flat, int count0, int dering)
{
    long scan, r;
    int j, count = count0;
    for (scan = 0; scan < 2L * SZ; scan++)
        if (flat[scan] > 1000) expand_top_c(flat, scan, (int)(scan & 511));
    for (r = 0; r < D; r++)
        for (j = 0; j < D; j++) {
            scan = 2L * SZ + r * N + j;
            if (flat[scan] > 1000) expand_bottom_c(flat, scan);
        }
    for (r = 0; r < D; r++)
        for (j = D; j < N; j++) {
            int v;
            scan = 2L * SZ + r * N + j;
            v = flat[scan];
            if (v > 1000) { expand_bottom_c(flat, scan); continue; }
            if (dering && iabs(v) > 8 && iabs(v) < 16) {
                if (j > D && j < N - 1) {
                    if (iabs(rd0(flat, scan - 1)) < 8) count++;
                    if (iabs(rd0(flat, scan + 1)) < 8) count++;
                    if (iabs(rd0(flat, scan - N)) < 8) count++;
                    if (iabs(rd0(flat, scan + N)) < 8) count++;
                    if (count >= 2)
                        flat[scan] = (int16_t)(v > 0 ? v + 1 : v - 1);
                    count = 0;
                }
            }
        }
}

/* marked-pixel smoothing in the x8 domain (models/decoder.py decode_y;
 * decoder/nhw_decoder.c:850-867) */
void nhw_smooth_marks(int16_t *jpeg, const int32_t *marks, long n_marks)
{
    long k;
    for (k = 0; k < n_marks; k++) {
        long rec = marks[k];
        long scan = ((rec >> 8) << 10) + (rec & 255);
        int res = lap8(jpeg, scan, N);
        if (iabs(res) < 116)
            jpeg[scan] = (int16_t)(((jpeg[scan] << 2)
                + jpeg[scan - 1] + jpeg[scan + 1]
                + jpeg[scan - N] + jpeg[scan + N] + 4) >> 3);
    }
}

/* UV residue sentinels 5003-5006 (models/decoder.py _uv_sentinels;
 * decoder/nhw_decoder.c:991-1069) */
static void uv_handle(int16_t *jpeg, int16_t *proc, long scan, long tgt)
{
    int v = jpeg[scan];
    if (v == 5005) {
        proc[tgt] -= 4; proc[tgt + 1] -= 4; jpeg[scan] = 0;
    } else if (v == 5006) {
        proc[tgt] += 4; proc[tgt + 1] += 4; jpeg[scan] = 0;
    } else if (v == 5003) { proc[tgt] -= 6; jpeg[scan] = 0; }
    else if (v == 5004) { proc[tgt] += 6; jpeg[scan] = 0; }
}

void nhw_uv_sentinels(int16_t *jpeg, int16_t *proc)
{
    const long half = SZ >> 1;
    long r, c, scan;
    for (r = 0; r < 128; r++)
        for (c = 128; c < D; c++) {
            scan = r * D + c;
            if (jpeg[scan] > 5000) uv_handle(jpeg, proc, scan, scan - 128);
        }
    for (r = 128; r < D; r++)
        for (c = 0; c < D; c++) {
            scan = r * D + c;
            if (jpeg[scan] > 5000)
                uv_handle(jpeg, proc, scan,
                          scan - half - (c >= 128 ? 128 : 0));
        }
}

/* ------------------------------------------------------------------ */
/* Residue stream finishing: marker dedupe + pair-delta pack + bit and
 * word planes (ops/residue.py finish_stream; encoder/nhw_encoder.c:
 * 1552-1635).                                                         */

void nhw_finish_stream(const int32_t *positions, long n_pos,
                       const int32_t *words, long n_words, int word_bits,
                       uint8_t *res_out, long *n_res,
                       uint8_t *bit_out, long *bit_len,
                       uint8_t *word_out, long *n_word_out)
{
    /* thread-local scratch (threaded pipeline — see nhw_offset_y) */
    static __thread int32_t dd[SZ + 2 * D + 8];
    static __thread int32_t nm[SZ + 2 * D + 8];
    long nd = 0, nnm = 0, o = 0, i, y, blk;

    /* dedupe isolated 254 markers between ascending neighbours */
    dd[nd++] = positions[0];
    for (i = 1; i < n_pos - 1; i++) {
        int v = positions[i];
        if (v == D - 2) {
            if (positions[i - 1] != D - 2 && positions[i + 1] != D - 2) {
                if (positions[i - 1] <= positions[i + 1]) dd[nd++] = v;
            } else dd[nd++] = v;
        } else dd[nd++] = v;
    }
    dd[nd++] = positions[n_pos - 1];

    /* pair-delta pack of the >>1 stream (last element only emitted when
     * consumed by a pair — reference loop bound) */
    res_out[o++] = (uint8_t)(dd[0] >> 1);
    i = 1;
    while (i < nd - 1) {
        int d1 = (dd[i] >> 1) - (dd[i - 1] >> 1);
        if (d1 >= 0 && d1 < 8) {
            int d2 = (dd[i + 1] >> 1) - (dd[i] >> 1);
            if (d2 >= 0 && d2 < 16) {
                res_out[o++] = (uint8_t)(128 + (d1 << 4) + d2);
                i += 2;
                continue;
            }
        }
        res_out[o++] = (uint8_t)(dd[i] >> 1);
        i += 1;
    }
    *n_res = o;

    /* LSB bit plane over non-marker positions */
    for (i = 0; i < nd; i++)
        if (dd[i] != D - 2) nm[nnm] = dd[i], nnm++;
    y = nnm >> 3;
    for (blk = 0; blk < y + 1; blk++) {
        int b = 0, k;
        for (k = 0; k < 8; k++) {
            long idx = blk * 8 + k;
            b = (b << 1) | (idx < nnm ? (nm[idx] & 1) : 0);
        }
        bit_out[blk] = (uint8_t)b;
    }
    *bit_len = y + 1;

    /* word plane: 1- or 2-bit entries */
    y = n_words >> 3;
    if (word_bits == 1) {
        for (blk = 0; blk < y + 1; blk++) {
            int b = 0, k;
            for (k = 0; k < 8; k++) {
                long idx = blk * 8 + k;
                b = (b << 1) | (idx < n_words ? (words[idx] & 1) : 0);
            }
            word_out[blk] = (uint8_t)b;
        }
        *n_word_out = y + 1;
    } else {
        for (blk = 0; blk < y + 1; blk++) {
            int b = 0, k;
            for (k = 0; k < 4; k++) {
                long idx = blk * 8 + k;
                b = (b << 2) | (idx < n_words ? (words[idx] & 3) : 0);
            }
            word_out[2 * blk] = (uint8_t)b;
            b = 0;
            for (k = 4; k < 8; k++) {
                long idx = blk * 8 + k;
                b = (b << 2) | (idx < n_words ? (words[idx] & 3) : 0);
            }
            word_out[2 * blk + 1] = (uint8_t)b;
        }
        *n_word_out = 2 * (y + 1);
    }
}

/* ------------------------------------------------------------------ */
/* UV LL2 byte-coding + exw continuation (models/encoder.py encode_uv;
 * encoder/nhw_encoder.c:2484-2515 U / 2783-2813 V)                    */

void nhw_ll2_code_uv(int16_t *pf, uint8_t *tree1_uv,
                     int32_t *exw, long *n_exw)
{
    long ne = 0, a_out = 0;
    int r, j;
    for (r = 0; r < 64; r++)
        for (j = 0; j < 64; j++) {
            long idx = (long)r * D + j;
            int scan = pf[idx];
            if (scan > 255 && (j > 0 || r > 0)) {
                exw[ne++] = r;
                exw[ne++] = j + 128;
                exw[ne++] = scan - 255 < 255 ? scan - 255 : 255;
                tree1_uv[a_out] = tree1_uv[a_out - 1];
                a_out++;
                pf[idx] = 0;
            } else if (scan < 0 && (j > 0 || r > 0)) {
                exw[ne++] = r;
                exw[ne++] = j;
                exw[ne++] = -(scan > -255 ? scan : -255);
                tree1_uv[a_out] = tree1_uv[a_out - 1];
                a_out++;
                pf[idx] = 0;
            } else {
                scan = scan > 255 ? 255 : (scan < 0 ? 0 : scan);
                tree1_uv[a_out] = (uint8_t)(scan & 254);
                a_out++;
                pf[idx] = 0;
            }
        }
    *n_exw = ne;
}

/* ------------------------------------------------------------------ */
/* Positional stream delta-undo (ops/streams.py _positions;
 * decoder/nhw_decoder.c:93-491 stage A)                               */

void nhw_stream_positions(const uint8_t *res_in, long n, int64_t *pos,
                          long n_entries, int row_step, int first_count,
                          int pack_shift)
{
    /* thread-local scratch (threaded pipeline — see nhw_offset_y) */
    static __thread uint8_t r[1 << 17];
    long stage = 0, count, i;
    if (n > (long)sizeof(r)) n = sizeof(r);
    for (i = 0; i < n; i++) r[i] = res_in[i];
    if (r[0] == 127) count = first_count;
    else {
        pos[stage++] = r[0] << 1;
        count = 0;
    }
    for (i = 1; i < n; i++) {
        int c = r[i];
        if (c >= 128) {
            int e = (c - 128) >> 4;
            int scan = c & 15;
            long j;
            if (r[i - 1] != 127) {
                j = (stage > 0 ? (pos[stage - 1] & 255) + (e << 1)
                               : (long)(e << 1));
            } else {
                r[i] = 127;
                count += 2L * row_step;
                continue;
            }
            if (j >= 254) { count += row_step; r[i] = 127; }
            else if (stage < n_entries) pos[stage++] = j + (count << pack_shift);
            j += scan << 1;
            if (j >= 254) { count += row_step; r[i] = 127; }
            else if (stage < n_entries) pos[stage++] = j + (count << pack_shift);
        } else if (c == 127) {
            count += row_step;
        } else {
            if (stage > 0 && (c << 1) < (pos[stage - 1] & 255)
                    && r[i - 1] != 127)
                count += row_step;
            if (stage < n_entries)
                pos[stage++] = (c << 1) + (count << pack_shift);
        }
    }
}

/* ------------------------------------------------------------------ */
/* Fused 2-D analysis stage (encoder/wavelet_filterbank.c:52-302):
 * the whole per-stage dance — zero-clear, RAW row pass, transpose,
 * optional snapshot, per-half column passes, LL transpose-back — in
 * one call, eliminating the per-substep interpreter round trips and
 * the numpy transpose copies.  Filter bodies are the exported
 * nhw_down_* routines called row-wise with in-row low/high splits. */

static void t16_block(const int16_t *src, long sw, int16_t *dst, long dw,
                      long n)
{
    /* dst[j][i] = src[i][j] for an n x n square, 32x32 blocked */
    long bi, bj, i, j;
    for (bi = 0; bi < n; bi += 32)
        for (bj = 0; bj < n; bj += 32) {
            long ei = bi + 32 < n ? bi + 32 : n;
            long ej = bj + 32 < n ? bj + 32 : n;
            for (i = bi; i < ei; i++)
                for (j = bj; j < ej; j++)
                    dst[j * dw + i] = src[i * sw + j];
        }
}

void nhw_analysis_stage(int16_t *jpeg, int16_t *process, long W,
                        long norder, int last_stage, int wvlts_order,
                        int want_snap, int16_t *snap_out)
{
    long r, k, h = norder >> 1;

    /* _zero_clear: flat[k*512 : k*512+h) = 0 for k < h, in the full
     * process plane's flat indexing */
    for (k = 0; k < h; k++)
        memset(process + k * 512, 0, (size_t)h * sizeof(int16_t));

    for (r = 0; r < norder; r++)
        nhw_down_iv(jpeg + r * W, 1, norder,
                    process + r * W, process + r * W + h);

    t16_block(process, W, jpeg, W, norder);

    if (want_snap && !last_stage && snap_out)
        memcpy(snap_out, jpeg, (size_t)(2 * 65536) * sizeof(int16_t));

    for (r = 0; r < h; r++)
        nhw_down_vi(jpeg + r * W, 1, norder,
                    process + r * W, process + r * W + h);
    for (r = h; r < norder; r++)
        nhw_down_53(jpeg + r * W, 1, norder,
                    process + r * W, process + r * W + h);

    if (last_stage != wvlts_order - 1)
        t16_block(process, W, jpeg, W, h);
}

/* Fused encoder-internal synthesis stage
 * (encoder/wavelet_filterbank.c:305-496): un-normalized row pass,
 * transpose, normalized row pass, optional transpose-back. */
void nhw_synthesis_stage(int16_t *jpeg, int16_t *process, long W,
                         long norder, int last_stage, int wvlts_order)
{
    long r, i, h = norder >> 1;
    int32_t tmp[512];
    for (r = 0; r < norder; r++) {
        nhw_synth_unnorm(jpeg + r * W, jpeg + r * W + h, 1, h, tmp);
        for (i = 0; i < norder; i++)
            process[r * W + i] = (int16_t)tmp[i];
    }
    t16_block(process, W, jpeg, W, norder);
    for (r = 0; r < norder; r++) {
        nhw_synth_norm(jpeg + r * W, jpeg + r * W + h, 1, h, tmp);
        for (i = 0; i < norder; i++)
            process[r * W + i] = (int16_t)tmp[i];
    }
    if (last_stage != wvlts_order - 1)
        t16_block(process, W, jpeg, W, norder);
}

/* Fused decode-side plane passes (models/decoder.py decode_y_back):
 * one un-normalized row pass over a whole square plane straight to
 * int16, a blocked transpose, and the final normalized row pass fused
 * with the u8 clip — each saves the L/H copies, the int32 staging
 * buffer and one full extra numpy pass. */
void nhw_synth_plane_unnorm16(const int16_t *plane, long n, int16_t *out)
{
    long r, k, h = n >> 1;
    for (r = 0; r < n; r++) {
        const int16_t *l = plane + r * n, *hh = l + h;
        int16_t *o = out + r * n;
        for (k = 0; k < h; k++) {
            int even = w16(k < h - 1 ? l[k] << 3 : l[h - 1] << 3);
            int odd = w16(k < h - 1 ? (l[k + 1] + l[k]) << 2
                                    : l[h - 1] << 3);
            int sub = k == 0 ? hh[0] << 2 : (hh[k] + hh[k - 1]) << 1;
            int add;
            if (k == 0) add = 5 * hh[0] - hh[1];
            else if (k == h - 1) add = 5 * hh[h - 1] - hh[h - 2];
            else add = 6 * hh[k] - hh[k + 1] - hh[k - 1];
            o[2 * k] = (int16_t)w16(even - sub);
            o[2 * k + 1] = (int16_t)w16(odd + add);
        }
    }
}

void nhw_transpose16(const int16_t *src, long n, int16_t *dst)
{
    t16_block(src, n, dst, n, n);
}

void nhw_synth_plane_norm_clip(const int16_t *plane, long n, uint8_t *out)
{
    long r, k, h = n >> 1;
    for (r = 0; r < n; r++) {
        const int16_t *l = plane + r * n, *hh = l + h;
        uint8_t *o = out + r * n;
        for (k = 0; k < h; k++) {
            int even = w16(k < h - 1 ? l[k] << 3 : l[h - 1] << 3);
            int odd = w16(k < h - 1 ? (l[k + 1] + l[k]) << 2
                                    : l[h - 1] << 3);
            int sub = k == 0 ? hh[0] << 2 : (hh[k] + hh[k - 1]) << 1;
            int add, e2, o2;
            if (k == 0) add = 5 * hh[0] - hh[1];
            else if (k == h - 1) add = 5 * hh[h - 1] - hh[h - 2];
            else add = 6 * hh[k] - hh[k + 1] - hh[k - 1];
            e2 = w16(even - sub);
            o2 = w16(odd + add);
            e2 = w16(e2 > 0 ? e2 + 32 : e2) >> 6;
            o2 = w16(o2 > 0 ? o2 + 32 : o2) >> 6;
            o[2 * k] = (uint8_t)(e2 < 0 ? 0 : e2 > 255 ? 255 : e2);
            o[2 * k + 1] = (uint8_t)(o2 < 0 ? 0 : o2 > 255 ? 255 : o2);
        }
    }
}

/* Serpentine scatter (encoder/nhw_encoder.c:2111-2132, 2542-2570):
 * dst[off + stride*perm[i]] = src[i] & 255 for the shared Y/UV
 * de-serpentine permutations. */
void nhw_scatter_u8(const int16_t *src, const int64_t *perm, long n,
                    uint8_t *dst, long stride, long off)
{
    long i;
    for (i = 0; i < n; i++)
        dst[off + stride * perm[i]] = (uint8_t)(src[i] & 255);
}

/* Map signed tokens (negative = symbol ~(v), positive = 65536+run) to
 * codebook positions through the two 256-entry tables — the Python
 * fancy-index version cost ~2 ms/img on dense streams. */
void nhw_map_tokens(const int32_t *tokens, long n,
                    const int32_t *sym_pos, const int32_t *run_pos,
                    int32_t *out)
{
    for (long i = 0; i < n; i++) {
        int32_t t = tokens[i];
        out[i] = t < 0 ? sym_pos[-t - 1] : run_pos[t - 65536];
    }
}
