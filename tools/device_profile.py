"""Device time of the codec's device programs on a GPU card.

Runs on one card, at batch 64 of chip_smoke's seeded images:

1. one ``jax.profiler`` trace of ``encode_batch_device`` at q20 and of
   ``decode_batch_device`` (host Huffman) on the resulting streams,
   reduced to the device time of every ``nhw.*`` named scope, beside the
   least bytes each scope has to move (inputs read once, outputs written
   once, computed from the shapes in ``SCOPE_BYTES``) as a share of the
   card's HBM peak, and each phase's device busy and idle share;
2. Y chain extraction in both exact forms, the peek-LUT + pointer-doubling
   gathers and the gather-free segment cascade: compile and steady time;
3. the full-scan Y automaton at scan unroll 2 and 8: compile and steady
   wall time (a 2^18-step scan: not traced);
4. plain XLA elementwise passes over 1 GiB of uint8, int32 and float32:
   the read + write rate each reaches, by device time and by steady
   wall time.

Kernel time is the sum of device event durations on the card's stream
lines.  Named scopes are resolved from each kernel's HLO op through the
optimized HLO that XLA dumps (``--xla_dump_to``); the persistent
compile cache is off so every program is compiled and dumped.

Usage: python tools/device_profile.py [--out DIR] [--seed N]
Prints one line per number and writes OUT/profile.json.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import numpy as np

HBM_PEAK = {"NVIDIA H100 80GB HBM3": 3.35e12}  # NVIDIA H100 SXM data sheet

# least bytes moved per image by each named scope (q20 encode, decode):
# its input planes read once and its output planes written once
_P512, _P256, _P128 = 512 * 512, 256 * 256, 128 * 128
SCOPE_BYTES = {
    "nhw.colorspace.matrix": 3 * _P512 + 2 * _P512 + 2 * _P512,
    "nhw.colorspace.down420": 2 * _P512 + 2 * _P256,
    "nhw.analysis_y.level1": 3 * 2 * _P512,
    "nhw.analysis_y.level2": 3 * 2 * _P256,
    "nhw.analysis_uv.level1": 2 * 3 * 2 * _P256,
    "nhw.analysis_uv.level2": 2 * 3 * 2 * _P128,
    "nhw.requant.synth": 3 * 2 * _P256,
    "nhw.requant.unmark": 4 * 2 * _P256,
    "nhw.requant.ladder": 5 * 2 * _P256,
    "nhw.requant.reanalysis": 3 * 2 * _P256,
    "nhw.decode.y_l2_synth": 2 * 2 * _P256,
    "nhw.decode.y_residue_scatter": 2 * 2 * 2 * _P256,
    "nhw.decode.y_l1_synth": 2 * 2 * _P512,
    "nhw.decode.y_hq_scatter": 0,
    "nhw.decode.y_mark_waves": (2 + 2 + 1) * _P512,
    "nhw.decode.y_final_synth": 2 * _P512 + _P512,
    "nhw.decode.uv_l2_synth": 2 * 2 * 2 * _P128,
    "nhw.decode.uv_sentinels": 2 * 3 * 2 * _P256,
    "nhw.decode.uv_l1_synth": 2 * 2 * 2 * _P256,
    "nhw.yuv_to_rgb": 3 * _P512 + 3 * _P512,
}

# where the card's kernels appear in the trace
DEVICE_PLANE, DEVICE_LINE = "/device:GPU", "stream"
_SCOPE_RE = re.compile(r"nhw\.[A-Za-z0-9_]+(?:\.[A-Za-z0-9_]+)*")
RESULTS: dict = {}
_DUMP: list = []  # the HLO dump directory, once dump_hlo() ran


def dump_hlo() -> None:
    """Have XLA dump every program it compiles from now on (must run
    before JAX creates its backend)."""
    d = tempfile.mkdtemp(prefix="nhw_hlo_")
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + f" --xla_dump_to={d}"
                               " --xla_dump_hlo_as_text").strip()
    _DUMP.append(d)


def out(key: str, value) -> None:
    RESULTS[key] = value
    print(f"{key}: {value}", flush=True)


# ---------------------------------------------------------------------------
# trace reduction


def _hlo_scopes() -> tuple[dict, dict]:
    """(program id, op) -> scope and (module name, op) -> {scopes} from
    the optimized HLO dumps."""
    by_id, by_name = {}, {}
    line_re = re.compile(r'^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*op_name="'
                         r'([^"]*)"')
    for p in glob.glob(os.path.join(_DUMP[0], "*after_optimizations.txt")):
        m = re.match(r"module_(\d+)\.([^.]+)\.", os.path.basename(p))
        if m is None:
            continue
        pid, mod = int(m.group(1)), m.group(2)
        for line in open(p):
            lm = line_re.match(line)
            if lm is None:
                continue
            sc = _SCOPE_RE.findall(lm.group(2))
            if sc:
                by_id[(pid, lm.group(1))] = sc[-1]
                by_name.setdefault((mod, lm.group(1)), set()).add(sc[-1])
    return by_id, by_name


def _device_events(trace_dir: str) -> list[tuple]:
    """(start_ns, duration_ns, name, stats) of every event on the GPU
    planes' stream lines of the newest trace under trace_dir."""
    from jax.profiler import ProfileData

    path = sorted(glob.glob(os.path.join(
        trace_dir, "plugins", "profile", "*", "*.xplane.pb")))[-1]
    evs = []
    for plane in ProfileData.from_file(path).planes:
        if not plane.name.startswith(DEVICE_PLANE):
            continue
        for line in plane.lines:
            if not line.name.lower().startswith(DEVICE_LINE):
                continue
            for e in line.events:
                evs.append((e.start_ns, e.duration_ns, e.name,
                            dict(e.stats)))
    return evs


def _busy_ns(evs) -> float:
    """Union of the event intervals (ns)."""
    busy, end = 0.0, -1.0
    for s, d, _, _ in sorted(evs, key=lambda e: e[0]):
        if s + d <= end:
            continue
        busy += s + d - max(s, end)
        end = s + d
    return busy


def _scope_of(name: str, st: dict, by_id: dict, by_name: dict) -> str:
    op, mod = st.get("hlo_op"), st.get("hlo_module")
    pid = st.get("program_id")
    if op is not None:
        if pid is not None and (int(pid), op) in by_id:
            return by_id[(int(pid), op)]
        cands = by_name.get((mod, op), set())
        if len(cands) == 1:
            return next(iter(cands))
        return f"(unscoped {mod})"
    if "memcpy" in name.lower() or "memset" in name.lower():
        return "(transfer)"
    return "(other)"


def traced(fn, tag: str):
    """Run fn under a profiler trace; returns (fn's result, device
    events, wall seconds)."""
    import jax

    d = tempfile.mkdtemp(prefix=f"nhw_trace_{tag}_")
    t0 = time.perf_counter()
    with jax.profiler.trace(d):
        res = fn()
    wall = time.perf_counter() - t0
    return res, _device_events(d), wall


def device_time(fn, args, reps: int = 20, tag: str = "t",
                trace: bool = True) -> dict:
    """Compile (first-call wall minus steady wall), steady wall per call
    and (when traced) device time per call of fn(*args).  Long scans are
    not traced: a step's kernels each leave an event."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        walls.append(time.perf_counter() - t0)
    res = {"compile_s": round(first - min(walls), 6),
           "steady_wall_s": round(min(walls), 6)}
    if not trace:
        return res

    def run():
        for _ in range(reps):
            jax.block_until_ready(fn(*args))

    _, evs, _ = traced(run, tag)
    res["device_s"] = sum(d for _, d, _, _ in evs) / reps / 1e9
    res["events_per_call"] = len(evs) / reps
    return res


# ---------------------------------------------------------------------------
# sections


def section_trace(imgs, peak: float) -> list[bytes]:
    from nhwcodec_tpu.parallel import device_pipeline as dp

    # warm every program first: the traced window holds no compilation
    streams, m = dp.encode_batch_device(imgs, 20)
    assert m.failures == 0
    got, m = dp.decode_batch_device(streams)
    assert m.failures == 0
    by_id, by_name = _hlo_scopes()
    out("hlo_ops_with_scope", len(by_id))
    b = len(imgs)
    for tag, fn in (("encode_q20", lambda: dp.encode_batch_device(imgs, 20)),
                    ("decode_q20", lambda: dp.decode_batch_device(streams))):
        _, evs, wall = traced(fn, tag)
        busy = _busy_ns(evs) / 1e9
        out(f"{tag}.wall_s", round(wall, 6))
        out(f"{tag}.device_busy_s", round(busy, 6))
        out(f"{tag}.device_idle_share", round(1 - busy / wall, 4))
        per: dict = {}
        for _, d, name, st in evs:
            sc = _scope_of(name, st, by_id, by_name)
            t, n = per.get(sc, (0.0, 0))
            per[sc] = (t + d / 1e9, n + 1)
        for sc, (t, n) in sorted(per.items(), key=lambda kv: -kv[1][0]):
            row = {"device_s": round(t, 6), "kernels": n}
            nb = SCOPE_BYTES.get(sc)
            if nb:
                row["least_bytes"] = nb * b
                row["hbm_share"] = round(nb * b / peak / t, 4)
            out(f"{tag}.scope.{sc}", row)
    return streams


def section_chain(streams: list[bytes]) -> None:
    from nhwcodec_tpu import tables as T
    from nhwcodec_tpu.ops import entropy_chain_scan as ecs
    from nhwcodec_tpu.ops import entropy_decode_device as edd
    from nhwcodec_tpu.utils.container import parse_nhw

    parsed = [parse_nhw(s) for s in streams]
    p1 = 4 * T.IM_SIZE
    nb = max(s.packet1.size * 32 for s in parsed)
    s_max = 1 << (min(p1, max(64, nb // 2 + 2)) - 1).bit_length()
    words, nbits, zone = edd._chain_batch_words(parsed)
    for name, fn in (("lut_gather", edd._codeword_chain_batch),
                     ("cascade", ecs.chain_starts_batch)):
        out(f"chain.{name}.b{len(parsed)}",
            device_time(lambda w, n, z, fn=fn: fn(w, n, z, s_max),
                        (words, nbits, zone), reps=10, tag=name))


def section_unroll(streams: list[bytes]) -> None:
    from unittest import mock

    import jax

    from nhwcodec_tpu import tables as T
    from nhwcodec_tpu.ops import entropy_decode_device as edd
    from nhwcodec_tpu.utils.container import parse_nhw

    parsed = [parse_nhw(s) for s in streams]
    p1 = 4 * T.IM_SIZE
    args = edd._y_batch_inputs(parsed, p1)[:5]
    for unroll, backend in ((2, "cpu"), (8, "gpu")):
        # the scan's unroll is chosen from the backend while tracing
        f = jax.jit(lambda *a: edd._y_automaton_batch.__wrapped__(*a, p1))
        t0 = time.perf_counter()
        with mock.patch.object(jax, "default_backend", lambda b=backend: b):
            jax.block_until_ready(f(*args))  # trace + compile under patch
        first = time.perf_counter() - t0
        r = device_time(f, args, tag=f"unroll{unroll}", trace=False)
        r["compile_s"] = round(first - r["steady_wall_s"], 6)
        out(f"y_automaton_full.unroll{unroll}.b{len(parsed)}", r)


def section_copy() -> None:
    import jax

    nbytes = 1 << 30
    for dt in (np.uint8, np.int32, np.float32):
        name = np.dtype(dt).name
        x = jax.device_put(np.zeros(nbytes // np.dtype(dt).itemsize, dt))
        r = device_time(jax.jit(lambda a: a + 1), (x,), tag=f"copy_{name}")
        r["device_read_plus_write_bytes_per_s"] = round(
            2 * nbytes / r["device_s"])
        r["wall_read_plus_write_bytes_per_s"] = round(
            2 * nbytes / r["steady_wall_s"])
        out(f"copy_1GiB.{name}", r)
        del x


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="device_profile_out")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    dump_hlo()

    import jax

    import chip_smoke
    from nhwcodec_tpu.utils.card import name_and_power_limit, require_gpu

    jax.config.update("jax_enable_compilation_cache", False)
    dev = require_gpu()
    out("device", {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())})
    out("card", name_and_power_limit())
    peak = HBM_PEAK[dev.device_kind]
    os.makedirs(args.out, exist_ok=True)

    def save():
        with open(os.path.join(args.out, "profile.json"), "w") as f:
            json.dump(RESULTS, f, indent=1, default=str)

    imgs = chip_smoke.make_images(args.seed, chip_smoke.BATCH)
    sections = (("copy", section_copy),
                ("trace", lambda: RESULTS.__setitem__(
                    "_streams", section_trace(imgs, peak))),
                ("chain", lambda: section_chain(RESULTS["_streams"][:32])),
                ("unroll", lambda: section_unroll(RESULTS["_streams"][:8])))
    for name, fn in sections:
        t0 = time.perf_counter()
        try:
            fn()
        except Exception as e:  # noqa: BLE001 — report, go on
            out(f"{name}.error", f"{type(e).__name__}: {e}"[:2000])
        out(f"{name}.section_wall_s", round(time.perf_counter() - t0, 3))
        streams = RESULTS.pop("_streams", None)
        save()
        if streams is not None:
            RESULTS["_streams"] = streams
    return 0


if __name__ == "__main__":
    sys.exit(main())
