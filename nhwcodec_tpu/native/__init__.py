"""Native host runtime: C implementations of the raster-carried scans.

``hotpass.c`` is compiled on first use with the system C compiler into
``_build/`` next to this package and loaded with ``ctypes`` (standard
library only).  Set ``NHW_NATIVE=0`` to force the pure Python path (the
two are bit-identical; the test suite runs both).
"""

from __future__ import annotations

import ctypes
import os
import re
import warnings
from pathlib import Path

_HERE = Path(__file__).resolve().parent

_CDEF = """
void nhw_histogram(const uint8_t *s, long p1, long p2,
                   int64_t *rle_buf, int64_t *rle_128);
long nhw_tokenize(const uint8_t *s, long p1, long p2, int select,
                  uint8_t *sel1_bits, long *n_sel1,
                  uint8_t *sel2_bits, long *n_sel2,
                  int32_t *tokens, long tokens_cap);
void nhw_analysis_stage(int16_t *jpeg, int16_t *process, long W,
                        long norder, int last_stage, int wvlts_order,
                        int want_snap, int16_t *snap_out);
void nhw_synthesis_stage(int16_t *jpeg, int16_t *process, long W,
                         long norder, int last_stage, int wvlts_order);
void nhw_scatter_u8(const int16_t *src, const int64_t *perm, long n,
                    uint8_t *dst, long stride, long off);
long nhw_emit(const uint8_t *s, long p1, long p2, int select, int zone,
              const int32_t *sym_pos, const int32_t *run_pos,
              const uint32_t *codes, const int32_t *lens,
              uint32_t *words, long words_cap, long a_in, int pack_in,
              uint8_t *sel1_bits, long *n_sel1,
              uint8_t *sel2_bits, long *n_sel2,
              int *pack_out);
void nhw_offset_y(int16_t *pf, int quality, int m1, int low4);
void nhw_snap_pass(int16_t *pf, int r0, int r1_, int col0, int col1,
                   int ratio_thr, int y_wavelet, int y_wavelet2,
                   int second_rule, int snap_guard6, int guard_col);
void nhw_column_ladder(int16_t *pf, int16_t *rf, int quality, int low1,
                       int low2, int hi1, int res_setting);
void nhw_classify(int16_t *pf, int16_t *rf, int hi1, int res_setting,
                  long *counts);
void nhw_scan_ladder(int16_t *jf, int16_t *pf, const int16_t *rf);
void nhw_offset_uv(int16_t *pf, int m2);
void nhw_select_codes(uint8_t *s, long *sel1_out, long *sel2_out);
void nhw_cap_long_runs(uint8_t *s);
void nhw_merge_crossing(uint8_t *s);
int nhw_decode_y(const uint32_t *words, const int32_t *nt1,
                 const int32_t *nt2, const int32_t *vals,
                 const int32_t *rles, const uint8_t *sel1,
                 const uint8_t *sel2, int zone_on, const int8_t *extra,
                 int16_t *out, long p1, long n_bits, long n_vals,
                 long n_sel1, long n_sel2);
int nhw_decode_uv(const uint32_t *words, const int32_t *nt1,
                  const int32_t *nt2, const int32_t *vals,
                  const int32_t *rles, const int8_t *extra,
                  int16_t *out, long p1, long n_bits, long n_vals);
void nhw_kernel_simple(const int32_t *res, const int32_t *cnt, int32_t *out);
void nhw_gradient_sums(const int16_t *p, int32_t *res, int32_t *cnt);
void nhw_upsample2x(const int16_t *p, uint8_t *out);
void nhw_kernel_simple_fused(const int16_t *p, int32_t *out);
void nhw_pair_walk_simple(int16_t *jf, const int32_t *kf);
void nhw_quantize_band(int16_t *jf, int16_t *pf, int low4, int m1, int part,
                       int r0, int r1_, int c0, int c1);
void nhw_offset_y_recons256(int16_t *jf, int16_t *pf, int quality, int m1,
                            int part, int16_t *highres_tmp,
                            const int32_t *highres_mem, int n_mem);
void nhw_uv_sentinel_marking(int16_t *pf, const int16_t *rf,
                             long rf_len, int res_uv);
void nhw_build_positional_stream(int16_t *rf, const int32_t *word_tab,
                                 const int16_t *repl_tab,
                                 int32_t *positions, long *n_pos,
                                 int32_t *words, long *n_words);
void nhw_offset_uv_recons256(int16_t *jf, int16_t *pf, int low5p, int m1,
                             int comp);
void nhw_ll2_code_y(int16_t *pf, uint8_t *tree1, uint8_t *ch_res,
                    int32_t *exw, long *n_exw,
                    int32_t *res4, long *n_res4, int low3p);
void nhw_y_highres_compression(const int32_t *h, long h_len,
                               const uint8_t *ch_res, int low5p,
                               int32_t *out, long *n_out, int *res_low_out,
                               int32_t *hr_word, long *n_hr_word,
                               int32_t *hr_mem, long *n_hr_mem);
void nhw_yuv_to_rgb(const uint8_t *y, const uint8_t *u, const uint8_t *v,
                    uint8_t *out, int mode, float yinv,
                    int rc, int gc, int bc);
void nhw_uv_highres_compression(const int32_t *h, int32_t *out, long *n_out);
void nhw_downsample_yuv420(const uint8_t *rgb, int mode, float yq, int qtz,
                           int16_t *y, uint8_t *u_out, uint8_t *v_out);
void nhw_synth_unnorm(const int16_t *L, const int16_t *H, long rows, long M,
                      int32_t *out);
void nhw_synth_norm(const int16_t *L, const int16_t *H, long rows, long M,
                    int32_t *out);
void nhw_synth_plane_unnorm16(const int16_t *plane, long n, int16_t *out);
void nhw_transpose16(const int16_t *src, long n, int16_t *dst);
void nhw_synth_plane_norm_clip(const int16_t *plane, long n, uint8_t *out);
void nhw_down_iv(const int16_t *X, long rows, long n,
                 int16_t *low, int16_t *high);
void nhw_down_53(const int16_t *X, long rows, long n,
                 int16_t *low, int16_t *high);
void nhw_down_vi(const int16_t *X, long rows, long n,
                 int16_t *low, int16_t *high);
int nhw_decode_dc_planes(const uint8_t *ch, const uint8_t *hr,
                         const int32_t *uv_off, int use_hr, int mode,
                         uint8_t *rc, long n_ch, long n_hr);
void nhw_mark_res256(const int16_t *process, int16_t *res256);
void nhw_unmark_res256(int16_t *flat, int16_t *res256);
void nhw_expand_sentinels_y(int16_t *flat, int count0, int dering);
void nhw_finish_stream(const int32_t *positions, long n_pos,
                       const int32_t *words, long n_words, int word_bits,
                       uint8_t *res_out, long *n_res,
                       uint8_t *bit_out, long *bit_len,
                       uint8_t *word_out, long *n_word_out);
void nhw_smooth_marks(int16_t *jpeg, const int32_t *marks, long n_marks);
void nhw_uv_sentinels(int16_t *jpeg, int16_t *proc);
void nhw_ll2_code_uv(int16_t *pf, uint8_t *tree1_uv,
                     int32_t *exw, long *n_exw);
void nhw_kernel_low4(const int32_t *res, const int32_t *cnt, int32_t *out,
                     int sharpness, int sharpn2);
void nhw_sentinel_pass_low4(int16_t *jf, int32_t *kf, uint8_t *sharp,
                            int sharpness, int sharpn2);
void nhw_pair_sharpen_low4(int16_t *jf, const int32_t *kf,
                           const uint8_t *sharp, int sharpness, int sharpn2);
void nhw_pair_walk_low(int16_t *jf, const int16_t *pf, int32_t *kf,
                       uint8_t *sharp_on, int low_on, int ladder_on,
                       int sharpness, int sharpn2, int n1);
void nhw_very_low_q_cleanup(int16_t *pf, int low9,
                            int x1, int x2, int x3, int x4, int x5,
                            int x6, int x7);
void nhw_lowest_q_band_cleanup(int16_t *pf, const int16_t *r3pad,
                               int ratio, int gt_low10,
                               int x1, int x2, int x3, int x4, int x5);
void nhw_low_q_ll1_cleanup(int16_t *pf, int x1, int ratio);
void nhw_uv_compare_ladder(int16_t *jf, const int16_t *pf,
                           const int16_t *rf, int strict, int oob0);
void nhw_uv_ll_smooth(int16_t *pf);
void nhw_pair_promotion(int16_t *pf);
long nhw_dering_mark(int16_t *proc, int32_t *marks_out);
void nhw_isolated_smooth(int16_t *flat, int diag_thr);
void nhw_uv_sharpen(int16_t *proc, int thr);
void nhw_map_tokens(const int32_t *tokens, long n,
                    const int32_t *sym_pos, const int32_t *run_pos,
                    int32_t *out);
void nhw_stream_positions(const uint8_t *res_in, long n, int64_t *pos,
                          long n_entries, int row_step, int first_count,
                          int pack_shift);
"""

_lib = None
_ffi = None
_failed = False


class _Ffi:
    """The two pointer helpers the call sites use, over ctypes:
    ``cast("<type> *", address)`` passes a raw address through and
    ``new("long *" | "int *", init)`` is a one-element out-parameter
    read back with ``[0]``."""

    NULL = None

    @staticmethod
    def cast(ctype: str, address: int) -> int:
        return address

    @staticmethod
    def new(ctype: str, init: int = 0):
        kind = {"long *": ctypes.c_long, "int *": ctypes.c_int}[ctype]
        return (kind * 1)(init)


_SCALARS = {"int": ctypes.c_int, "long": ctypes.c_long,
            "float": ctypes.c_float, "void": None}


def _bind(lib) -> None:
    """Set argtypes/restype of every function declared in _CDEF
    (pointers are passed as raw addresses)."""
    for decl in _CDEF.replace("\n", " ").split(";"):
        m = re.match(r"\s*(\w+)\s+(\w+)\((.*)\)\s*$", decl)
        if m is None:
            continue
        ret, name, args = m.groups()
        fn = getattr(lib, name)
        fn.restype = _SCALARS[ret]
        fn.argtypes = [ctypes.c_void_p if "*" in a
                       else _SCALARS[a.split()[0]]
                       for a in args.split(",")]


def _cc(args: list) -> None:
    import subprocess

    r = subprocess.run(["cc", *args], capture_output=True, text=True,
                       timeout=600)
    if r.returncode != 0:
        raise RuntimeError(f"cc {' '.join(args)} failed:\n"
                           f"{r.stderr.strip()[-4000:]}")


def _compile(obj: Path, so: Path, compile_args: list, link_args: list,
             extra: list = ()) -> None:
    _cc(["-c", str(_HERE / "hotpass.c"), "-o", str(obj), "-fPIC",
         *compile_args, *extra])
    _cc(["-shared", "-pthread", str(obj), "-o", str(so), *link_args,
         *extra])


def _compile_pgo(tmp: Path, so: Path, compile_args: list) -> None:
    """Three-step PGO build: instrumented compile -> training subprocess
    (loads the instrumented library, never touches an accelerator) ->
    -fprofile-use recompile.  Any failure falls back to the plain
    build; output is byte-identical either way (PGO only reorders and
    annotates code)."""
    import subprocess
    import sys

    obj = tmp / "hotpass.o"
    try:
        _compile(obj, so, compile_args, [],
                 ["-fprofile-generate", "-fprofile-update=atomic"])
        env = dict(os.environ, JAX_PLATFORMS="cpu", NHW_NATIVE="1")
        r = subprocess.run(
            [sys.executable, "-m", "nhwcodec_tpu.native._pgo_train",
             str(so)],
            timeout=240, env=env, cwd=str(_HERE.parent.parent),
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        if r.returncode != 0 or not list(tmp.glob("*.gcda")):
            raise RuntimeError("pgo training produced no profile")
        _compile(obj, so, compile_args, [],
                 ["-fprofile-use", "-fprofile-correction",
                  "-Wno-missing-profile"])
    except Exception:  # noqa: BLE001 — PGO is an optimization only
        _compile(obj, so, compile_args, [])


def available() -> bool:
    return _load() is not None


def _cpu_id() -> str:
    """Model name and feature flags of this machine's CPU (what
    -march=native compiles for)."""
    try:
        info = Path("/proc/cpuinfo").read_text().splitlines()
    except OSError:
        return "cpu-unknown"
    keys = ("model name", "flags")
    return "|".join(next((ln for ln in info if ln.startswith(k)), "")
                    for k in keys)


def _build() -> Path:
    """Build (or reuse) the shared library; returns its path."""
    import fcntl
    import hashlib
    import platform
    import shutil
    import subprocess

    # -ffp-contract=off: -march=native would otherwise fuse the
    # colorspace multiply-adds into FMAs, changing float roundings vs
    # the reference (and the numpy fallback path)
    asan = os.environ.get("NHW_NATIVE_ASAN", "0") == "1"
    if asan:
        # memory-safety audit build (tests/test_sanitizers.py); needs
        # LD_PRELOAD=libasan.so in the running process
        compile_args = ["-O1", "-g", "-fsanitize=address",
                        "-fno-omit-frame-pointer", "-ffp-contract=off"]
        link_args = ["-fsanitize=address"]
    else:
        compile_args = ["-O3", "-march=native", "-ffp-contract=off"]
        link_args = []
    # profile-guided optimization for the branch-heavy raster automata
    # (byte-identical output; NHW_NATIVE_PGO=0 skips)
    pgo = not asan and os.environ.get("NHW_NATIVE_PGO", "1") != "0"

    build_dir = _HERE / ("_build_asan" if asan else "_build")
    build_dir.mkdir(exist_ok=True)
    so = build_dir / "_hotpass.so"
    stamp = build_dir / "_hotpass.buildhash"
    # content-keyed cache: a stale library from an older hotpass.c would
    # load silently and miss new symbols.  The key includes the
    # toolchain + machine fingerprint: with -march=native a library
    # carried to a different CPU would pass a source-only hash check and
    # can SIGILL.
    src = (_HERE / "hotpass.c").read_text()
    try:
        ccver = subprocess.run(
            ["cc", "--version"], capture_output=True, text=True,
            timeout=10).stdout.splitlines()[0]
    except Exception:  # noqa: BLE001
        ccver = "cc-unknown"
    want = hashlib.sha256(
        (src + _CDEF + " ".join(compile_args) + ccver
         + platform.machine() + _cpu_id() + ("pgo" if pgo else ""))
        .encode()).hexdigest()

    def fresh():
        return so.exists() and stamp.exists() and \
            stamp.read_text().strip() == want

    if fresh():
        return so
    # serialize concurrent first builds (spawn-pool workers all import
    # on a cold cache) and publish the library atomically
    with open(build_dir / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if fresh():
            return so
        tmp = build_dir / f"tmp{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir()
        try:
            out = tmp / "_hotpass.so"
            if pgo:
                _compile_pgo(tmp, out, compile_args)
            else:
                _compile(tmp / "hotpass.o", out, compile_args, link_args)
            os.replace(out, so)
            (tmp / "stamp").write_text(want)
            os.replace(tmp / "stamp", stamp)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    return so


def _load():
    global _lib, _ffi, _failed
    if _lib is not None:
        return _lib
    if os.environ.get("NHW_NATIVE", "1") == "0" or _failed:
        return None
    try:
        lib = ctypes.CDLL(str(_build()))
        _bind(lib)
    except Exception as e:  # noqa: BLE001 — fall back to pure Python
        _failed = True
        warnings.warn(f"native host runtime unavailable, using the "
                      f"pure-Python scans (much slower): {e}",
                      RuntimeWarning, stacklevel=2)
        return None
    _lib, _ffi = lib, _Ffi()
    return _lib


def ffi():
    _load()
    return _ffi
