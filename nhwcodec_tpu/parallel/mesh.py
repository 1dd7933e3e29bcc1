"""Device-mesh data-parallel batch codec steps.

The NHW codec has no training state and no sequence axis; the scaling axis
is the *batch of independent images* (SURVEY.md section 2.4).  The primary
sharding is therefore DP: a ``Mesh`` with a ``data`` axis, batch dimension
sharded across it, per-image compute replicated.  Throughput metrics are
reduced with ``psum`` over the mesh so every host sees the aggregate.

Static tables (quantization ladders, Huffman codebooks) are module
constants — XLA replicates them to every device at compile time, the
device-mesh version of the reference's implicit "everything in one
address space" (the reference has no distribution at all).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from nhwcodec_tpu.models import transform


def make_mesh(devices=None, axis: str = "data") -> Mesh:
    """A 1-D data-parallel mesh over all (or the given) devices."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    return Mesh(devices.reshape(-1), (axis,))


def shard_batch(mesh: Mesh, *arrays, axis: str = "data"):
    """Place each (B, ...) array batch-sharded over the mesh."""
    sh = NamedSharding(mesh, P(axis))
    return tuple(jax.device_put(a, sh) for a in arrays)


@partial(jax.jit, static_argnames=("axis",))
def _decode_step_psum(y, u, v, axis: str):
    rgb = transform.decode_transform(y, u, v)
    # aggregate megapixels decoded across the mesh
    mp = jnp.float32(y.shape[0] * y.shape[1] * y.shape[2]) / 1e6
    return rgb, mp


def decode_batch_step(mesh: Mesh, y, u, v, axis: str = "data"):
    """Sharded batched decode transform: coefficient planes -> RGB.

    y: (B, 512, 512) int16, u/v: (B, 256, 256) int16 with B divisible by
    the mesh size.  Returns ((B, 512, 512, 3) uint8, aggregate megapixels).
    """
    sh_in = NamedSharding(mesh, P(axis))
    out_sh = (NamedSharding(mesh, P(axis)), NamedSharding(mesh, P()))
    f = jax.jit(
        lambda yy, uu, vv: _decode_step_psum(yy, uu, vv, axis),
        in_shardings=(sh_in, sh_in, sh_in),
        out_shardings=out_sh,
    )
    return f(y, u, v)


def sharded_megapixels(mesh: Mesh, y, axis: str = "data"):
    """Mesh-global megapixel count of a batch-sharded (B, H, W) plane:
    each device contributes its local shard count and a ``psum`` over
    the ``data`` axis (an NCCL all-reduce across cards) gives every
    device the aggregate."""
    f = jax.jit(jax.shard_map(
        lambda x: jax.lax.psum(
            jnp.float32(x.shape[0] * x.shape[1] * x.shape[2]) / 1e6,
            axis),
        mesh=mesh, in_specs=P(axis), out_specs=P()))
    return float(f(y))


# per-image shared-memory record shipped to the host-half worker
# processes: the (possibly pre-filtered) planes plus every device-
# computed transform state models.device_stages emits
_REC_FIELDS = (
    ("y1", (512, 512), np.int16), ("orig", (512, 512), np.int16),
    ("u", (256, 256), np.uint8), ("v", (256, 256), np.uint8),
    ("py0", (512, 512), np.int16), ("py1", (512, 512), np.int16),
    ("py2", (256, 256), np.int16), ("py3", (256, 512), np.int16),
    ("pu0", (256, 256), np.int16), ("pu1", (256, 256), np.int16),
    ("pu2", (128, 128), np.int16),
    ("pv0", (256, 256), np.int16), ("pv1", (256, 256), np.int16),
    ("pv2", (128, 128), np.int16),
)
_REC_OFFS = {}
_REC_SIZE = 0
for _name, _shape, _dt in _REC_FIELDS:
    _REC_OFFS[_name] = _REC_SIZE
    _REC_SIZE += int(np.prod(_shape)) * np.dtype(_dt).itemsize


def _rec_views(buf, slot: int):
    base = slot * _REC_SIZE
    out = {}
    for name, shape, dt in _REC_FIELDS:
        off = base + _REC_OFFS[name]
        n = int(np.prod(shape)) * np.dtype(dt).itemsize
        out[name] = np.ndarray(shape, dt, buffer=buf[off: off + n])
    return out


def _host_half_shm(args):
    """Process-pool worker: run one image's host half (raster scans +
    entropy + container) from a SharedMemory record.  Returns
    (idx, .nhw bytes | None, error | None)."""
    idx, slot, shm_name, quality = args
    try:
        from multiprocessing import shared_memory

        from nhwcodec_tpu import tables as T
        from nhwcodec_tpu.models.encoder import encode_from_planes

        shm = shared_memory.SharedMemory(name=shm_name)
        try:
            r = {k: v.copy() for k, v in _rec_views(shm.buf, slot).items()}
        finally:
            shm.close()
        snap_on = quality > T.HIGH1
        data = encode_from_planes(
            r["y1"], r["u"], r["v"], quality, y_original=r["orig"],
            pre_y=(r["py0"], r["py1"], r["py2"],
                   r["py3"] if snap_on else None),
            pre_u=(r["pu0"], r["pu1"], r["pu2"]),
            pre_v=(r["pv0"], r["pv1"], r["pv2"]))
        return idx, data, None
    except Exception as e:  # noqa: BLE001 — per-image failure isolation
        return idx, None, f"{type(e).__name__}: {e}"


def _chunk_front(mesh, images, quality, axis, n_workers):
    """Device front end for one chunk: sharded colorspace + (optional
    host pre-filter on a thread pool) + sharded analysis.  Returns
    (y1s, origs, u, v, pre_y, pre_u, pre_v) as host arrays."""
    from concurrent.futures import ThreadPoolExecutor

    from nhwcodec_tpu import tables as T
    from nhwcodec_tpu.models import device_stages as ds
    from nhwcodec_tpu.ops import prefilter

    b = len(images)
    sh = NamedSharding(mesh, P(axis))
    rgb = jax.device_put(np.ascontiguousarray(images), sh)

    if quality > T.HIGH1:
        (y, u, v), pre_y, pre_u, pre_v = ds.encode_front_device(
            rgb, quality)
        y_np = np.asarray(y)  # ONE batched gather, not b sliced transfers
        y1s = [y_np[i] for i in range(b)]
        origs = y1s
    else:
        yd, ud, vd = ds.colorspace_front_device(rgb, quality)
        yd_np = np.asarray(yd)
        origs = [yd_np[i] for i in range(b)]
        if quality < T.HIGH2:
            if n_workers > 1 and b > 1:
                with ThreadPoolExecutor(max_workers=n_workers) as ex:
                    y1s = list(ex.map(
                        lambda o: prefilter.pre_process_y(o, quality),
                        origs))
            else:
                y1s = [prefilter.pre_process_y(o, quality) for o in origs]
        else:
            y1s = origs
        y1_sh = jax.device_put(np.stack(y1s), sh)
        u_sh = jax.device_put(np.ascontiguousarray(ud), sh)
        v_sh = jax.device_put(np.ascontiguousarray(vd), sh)
        if mesh.size > 1:
            pre_y, pre_u, pre_v = ds.analysis_front_sharded(
                mesh, y1_sh, u_sh, v_sh, quality, axis=axis)
        else:
            pre_y, pre_u, pre_v = ds.analysis_front_device(
                y1_sh, u_sh, v_sh, quality)
        u, v = ud, vd

    pre_y = tuple(np.asarray(a) if a is not None else None for a in pre_y)
    pre_u = tuple(np.asarray(a) for a in pre_u)
    pre_v = tuple(np.asarray(a) for a in pre_v)
    return y1s, origs, np.asarray(u), np.asarray(v), pre_y, pre_u, pre_v


def encode_batch_sharded(mesh: Mesh, images: np.ndarray, quality: int = 20,
                         axis: str = "data", workers: int | None = None,
                         device_pack: bool | None = None,
                         chunk: int | None = None):
    """Full byte-exact batch encode with the device front end sharded
    over the mesh (the BASELINE "1k images, DP over images, ordered
    bitstream gather" configuration).

    The batch runs in chunks: each chunk's RGB is placed batch-sharded
    and the exact colorspace + both analysis levels run as one sharded
    XLA program (GSPMD partitions the batch axis; per-image compute has
    no cross-shard edges, so no resharding collectives are inserted —
    the only mesh communication is the psum metric and the output
    gather).  The host raster scans + entropy + container fan out over
    the persistent process pool (SharedMemory transport of the device
    states), overlapped with the next chunk's device front; with
    ``device_pack`` the host half runs on threads instead and each
    chunk's Huffman bit packing is ONE batched device prefix-sum
    program.  ``device_pack=None`` resolves by backend: device packing
    on accelerators, host packing on the CPU backend (where a device
    "pack launch" is just more work for the same cores).  Byte-identical
    to ``encode`` either way (tests/test_parallel.py).

    Returns (streams in submission order — None for failed images — and
    aggregate megapixels from the on-mesh psum).
    """
    import os
    from concurrent.futures import ThreadPoolExecutor

    from nhwcodec_tpu import tables as T
    from nhwcodec_tpu.models.encoder import (encode_from_planes,
                                             finish_deferred)
    from nhwcodec_tpu.parallel import api

    b = len(images)
    n_workers = (os.cpu_count() or 1) if workers is None else workers
    if device_pack is None:
        device_pack = jax.default_backend() != "cpu"
    if chunk is None:
        chunk = max(mesh.size, mesh.size * (32 // mesh.size))
    chunk = max(mesh.size, (chunk // mesh.size) * mesh.size)

    snap_on = quality > T.HIGH1
    streams: list[bytes | None] = [None] * b
    mp = 0.0

    def _pre_tuples(pre_y, pre_u, pre_v, k):
        return ((pre_y[0][k], pre_y[1][k], pre_y[2][k],
                 pre_y[3][k] if snap_on else None),
                tuple(a[k] for a in pre_u), tuple(a[k] for a in pre_v))

    if device_pack or n_workers <= 1:
        # threads: C scans release the GIL; the device packs each chunk's
        # streams in one program
        def _run_chunk(lo):
            imgs = images[lo: lo + chunk]
            y1s, origs, u, v, pre_y, pre_u, pre_v = _chunk_front(
                mesh, imgs, quality, axis, n_workers)

            def _one(k):
                py, pu, pv = _pre_tuples(pre_y, pre_u, pre_v, k)
                return encode_from_planes(
                    y1s[k], np.ascontiguousarray(u[k]),
                    np.ascontiguousarray(v[k]), quality,
                    y_original=origs[k], pre_y=py, pre_u=pu, pre_v=pv,
                    defer_pack=device_pack)

            n = len(imgs)
            if n_workers > 1 and n > 1:
                with ThreadPoolExecutor(max_workers=n_workers) as ex:
                    results = list(ex.map(_one, range(n)))
            else:
                results = [_one(k) for k in range(n)]
            if device_pack:
                results = finish_deferred(results)
            streams[lo: lo + len(results)] = results
            return sharded_megapixels(
                mesh, jax.device_put(np.stack(y1s),
                                     NamedSharding(mesh, P(axis))), axis)

        for lo in range(0, b, chunk):
            mp += _run_chunk(lo)
        return streams, mp

    # process-pool path: per-chunk SharedMemory records, worker scans
    # overlapped with the next chunk's device front
    from multiprocessing import shared_memory

    pool = api._pool(n_workers)
    pending = []  # (futures, shm)

    def _drain(entry):
        futs, shm = entry
        try:
            for f in futs:
                idx, data, err = f.result()
                if err is None:
                    streams[idx] = data
        finally:
            shm.close()
            shm.unlink()

    for lo in range(0, b, chunk):
        imgs = images[lo: lo + chunk]
        y1s, origs, u, v, pre_y, pre_u, pre_v = _chunk_front(
            mesh, imgs, quality, axis, n_workers)
        mp += sharded_megapixels(
            mesh, jax.device_put(np.stack(y1s),
                                 NamedSharding(mesh, P(axis))), axis)
        n = len(imgs)
        shm = shared_memory.SharedMemory(create=True, size=n * _REC_SIZE)
        for k in range(n):
            r = _rec_views(shm.buf, k)
            r["y1"][:] = y1s[k]
            r["orig"][:] = origs[k]
            r["u"][:] = u[k]
            r["v"][:] = v[k]
            py, pu, pv = _pre_tuples(pre_y, pre_u, pre_v, k)
            for name, a in (("py0", py[0]), ("py1", py[1]), ("py2", py[2])):
                r[name][:] = a
            if py[3] is not None:
                r["py3"][:] = py[3]
            for name, a in zip(("pu0", "pu1", "pu2"), pu):
                r[name][:] = a
            for name, a in zip(("pv0", "pv1", "pv2"), pv):
                r[name][:] = a
            del r  # drop shm views before any later close() (BufferError)
        futs = [pool.submit(_host_half_shm, (lo + k, k, shm.name, quality))
                for k in range(n)]
        pending.append((futs, shm))
        while len(pending) > 2:  # bound in-flight shm to ~2 chunks
            _drain(pending.pop(0))

    while pending:
        _drain(pending.pop(0))
    return streams, mp
