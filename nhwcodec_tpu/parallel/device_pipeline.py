"""Pipelined batch encode and decode with the plane transforms on the device.

Per chunk of the batch, the stages are:

  D1  device: exact colorspace (ops.colorspace_device)      [card]
  H1  host:   Y pre-filter raster automaton (q < HIGH2)     [C scans]
  D2  device: both analysis levels (models.device_stages)   [card]
  H1b host:   requant mark + offset(part=1) greedy automata [C scans]
  D3  device: requant feedback tail — synthesis + unmark +
      compare-ladder fixpoint + re-analysis (device_requant) [card]
  H2  host:   residue/quantize/entropy/container scans      [C scans]

Chunks run on a thread pool: while one chunk's host scans run (the
ctypes C calls release the GIL), other chunks' device launches and host
scans proceed — so device and host stages overlap and the device is
load-bearing for every byte produced (the output is byte-identical to
the host-only ``encode``; tests/test_device_encode.py).

For q > HIGH1 (no Y pre-filter) D1+D2 fuse into one launch.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from nhwcodec_tpu import tables as T
from nhwcodec_tpu.parallel.api import BatchMetrics


def default_chunk(b: int, workers: int | None = None) -> int:
    """Images per device launch when the caller gives none: the batch
    split evenly over the host threads, at most 16.  With as many cores
    as images this is 1."""
    n_workers = workers or os.cpu_count() or 1
    return max(1, min(16, -(-b // n_workers)))


def _encode_chunk_device(images: np.ndarray, quality: int,
                         out: list, idxs: list[int],
                         device_pack: bool = True) -> int:
    """Run one chunk through D1/H1/D2/D3/H2; returns failure count.
    ``device_pack``: defer each image's Huffman bit packing and run the
    whole chunk's packs as ONE device prefix-sum program (D4)."""
    from nhwcodec_tpu.models import device_requant, device_stages as ds
    from nhwcodec_tpu.models.encoder import (encode_from_planes,
                                             finish_deferred)
    from nhwcodec_tpu.ops import prefilter, requant

    failures = 0
    try:
        if quality > T.HIGH1:
            (y, u, v), pre_y, pre_u, pre_v = ds.encode_front_device(
                images, quality)
            y1s = [np.ascontiguousarray(y[i]) for i in range(len(idxs))]
            origs = y1s
        else:
            y, u, v = ds.colorspace_front_device(images, quality)
            origs = [np.ascontiguousarray(y[i]) for i in range(len(idxs))]
            if quality < T.HIGH2:
                y1s = [prefilter.pre_process_y(o, quality) for o in origs]
            else:
                y1s = origs
            pre_y, pre_u, pre_v = ds.analysis_front_device(
                np.stack(y1s), u, v, quality)

        # D3: the requant feedback tail on device (host runs the greedy
        # mark + offset(part=1) automata in between — encode_y then
        # skips its host requant block via requant_done)
        requant_done = quality > T.LOW14
        if requant_done:
            jpegs = np.array(pre_y[0], np.int16)
            procs = np.array(pre_y[1], np.int16)
            r256s = np.array(pre_y[2], np.int16)
            for k in range(len(idxs)):
                requant.mark_res256(procs[k], r256s[k])
                requant.offset_y_recons256(jpegs[k], procs[k], quality,
                                           8, part=1)
            dj, dp, drc = device_requant.requant_tail_device(
                jpegs, procs, r256s)
            pre_y = (np.asarray(dj), np.asarray(dp), np.asarray(drc),
                     pre_y[3] if quality > T.HIGH1 else None)
    except Exception:  # noqa: BLE001 — whole-chunk device failure
        return len(idxs)

    snap_on = quality > T.HIGH1
    deferred: list[tuple[int, object]] = []
    for k, i in enumerate(idxs):
        try:
            py = (pre_y[0][k], pre_y[1][k], pre_y[2][k],
                  pre_y[3][k] if snap_on else None)
            r = encode_from_planes(
                y1s[k], np.ascontiguousarray(u[k]),
                np.ascontiguousarray(v[k]), quality,
                y_original=origs[k],
                pre_y=py,
                pre_u=tuple(a[k] for a in pre_u),
                pre_v=tuple(a[k] for a in pre_v),
                requant_done=requant_done,
                defer_pack=device_pack)
            if device_pack:
                deferred.append((i, r))
            else:
                out[i] = r
        except Exception:  # noqa: BLE001 — per-image failure isolation
            failures += 1
    if deferred:
        try:
            streams = finish_deferred([d for _, d in deferred])
            for (i, _), s in zip(deferred, streams):
                out[i] = s
        except Exception:  # noqa: BLE001 — isolate a bad pack per image
            for i, d in deferred:
                try:
                    out[i] = finish_deferred([d])[0]
                except Exception:  # noqa: BLE001
                    failures += 1
    return failures


def encode_batch_device(images: np.ndarray, quality: int = 20,
                        workers: int | None = None,
                        chunk: int | None = None,
                        trace_dir: str | None = None,
                        device_pack: bool = True,
                        scans_on_device: bool = False
                        ) -> tuple[list[bytes | None], BatchMetrics]:
    """Encode a (B, 512, 512, 3) uint8 batch with device transforms.

    Returns (bitstreams in submission order — None for failures — and
    metrics).  ``workers``: host thread count (default: cpu count);
    ``chunk``: images per device launch (default: B/workers capped 16);
    ``device_pack``: run each chunk's Huffman bit packing as one device
    prefix-sum program (default on);
    ``scans_on_device``: the full-device configuration — every
    post-transform raster scan (E11/E12/E14-E17) runs as batched
    device programs (models.device_encode_scans), symmetric to
    decode's ``entropy_on_device``; host keeps the E4 pre-filter, the
    E10 greedy passes and the tokenizer.  Byte-identical either way;
    requires quality <= HIGH1;
    ``trace_dir``: capture a ``jax.profiler`` trace of the whole batch
    into this directory (view with TensorBoard/Perfetto — the device
    stages appear under their ``nhw.*`` named scopes).
    """
    import jax

    if trace_dir is not None:
        with jax.profiler.trace(trace_dir):
            return encode_batch_device(images, quality, workers, chunk,
                                       device_pack=device_pack,
                                       scans_on_device=scans_on_device)

    if scans_on_device:
        from nhwcodec_tpu.models import device_encode_scans as des

        t0 = time.perf_counter()
        streams = des.encode_batch_scans_device(images, quality)
        return streams, BatchMetrics(
            images=len(images), wall_s=time.perf_counter() - t0,
            megapixels=len(images) * 512 * 512 / 1e6)

    jax.devices()  # initialize the backend on the main thread: plugin
    # discovery is not thread-safe on first touch
    t0 = time.perf_counter()
    b = len(images)
    n_workers = workers or os.cpu_count() or 1
    chunk = chunk or default_chunk(b, n_workers)
    out: list[bytes | None] = [None] * b
    m = BatchMetrics(images=b, megapixels=b * 512 * 512 / 1e6)

    jobs = []
    for lo in range(0, b, chunk):
        idxs = list(range(lo, min(lo + chunk, b)))
        jobs.append((np.ascontiguousarray(images[lo: lo + chunk]), idxs))

    if n_workers == 1 or len(jobs) == 1:
        for imgs, idxs in jobs:
            m.failures += _encode_chunk_device(imgs, quality, out, idxs,
                                               device_pack)
    else:
        with ThreadPoolExecutor(max_workers=n_workers) as ex:
            futs = [ex.submit(_encode_chunk_device, imgs, quality, out,
                              idxs, device_pack) for imgs, idxs in jobs]
            for f in futs:
                m.failures += f.result()
    m.wall_s = time.perf_counter() - t0
    return out, m


def _decode_chunk_device(datas: list, out: list, idxs: list[int],
                         entropy_on_device: bool = False) -> int:
    from nhwcodec_tpu.models import device_decode as dd

    try:
        rgbs = dd.decode_batch_device(
            datas, entropy_on_device=entropy_on_device)
        for k, i in enumerate(idxs):
            out[i] = rgbs[k]
        return 0
    except Exception:  # noqa: BLE001 — fall back to per-image isolation
        failures = 0
        for k, i in enumerate(idxs):
            try:
                out[i] = dd.decode_batch_device(
                    [datas[k]], entropy_on_device=entropy_on_device)[0]
            except Exception:  # noqa: BLE001
                failures += 1
        return failures


def decode_batch_device(datas: list, workers: int | None = None,
                        chunk: int | None = None,
                        entropy_on_device: bool = False
                        ) -> tuple[list, BatchMetrics]:
    """Decode a list of .nhw byte strings with the synthesis back end +
    colorspace on device (models.device_decode) and the sequential
    automata on a host thread pool, chunk-overlapped like the encode
    pipeline.  Returns (RGB arrays in submission order — None for
    failures — and metrics); byte-identical to the host decoder.
    ``entropy_on_device=True`` additionally runs the Huffman unpackers
    on the device (see models.device_decode.decode_batch_device) — the
    full-device decode configuration."""
    import jax

    jax.devices()  # thread-safe backend init (see encode_batch_device)
    t0 = time.perf_counter()
    b = len(datas)
    n_workers = workers or os.cpu_count() or 1
    chunk = chunk or default_chunk(b, n_workers)
    out: list = [None] * b
    m = BatchMetrics(images=b, megapixels=b * 512 * 512 / 1e6)

    jobs = []
    for lo in range(0, b, chunk):
        idxs = list(range(lo, min(lo + chunk, b)))
        jobs.append((list(datas[lo: lo + chunk]), idxs))

    if n_workers == 1 or len(jobs) == 1:
        for ds_, idxs in jobs:
            m.failures += _decode_chunk_device(ds_, out, idxs,
                                               entropy_on_device)
    else:
        with ThreadPoolExecutor(max_workers=n_workers) as ex:
            futs = [ex.submit(_decode_chunk_device, ds_, out, idxs,
                              entropy_on_device)
                    for ds_, idxs in jobs]
            for f in futs:
                m.failures += f.result()
    m.wall_s = time.perf_counter() - t0
    return out, m
