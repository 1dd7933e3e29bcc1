"""Mesh scaling table for the sharded full-codec step.

Runs ``parallel.mesh.encode_batch_sharded`` (exact device front end
batch-sharded over a Mesh + host entropy + ordered gather) on a
1-device mesh and on a mesh over every visible device, and prints a
scaling table.

On virtual CPU devices (which all share the machine's physical cores)
the table measures *sharding overhead* (GSPMD partitioning + psum +
gather), not hardware speedup; per-shard work has no cross-shard edges,
so on real cards the device phase scales with card count until the
per-host scan budget binds.

Run:
  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
    python tools/mesh_scaling.py [B] [quality]
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> None:
    import jax

    from nhwcodec_tpu.models import encoder
    from nhwcodec_tpu.parallel import mesh as pmesh

    b = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    q = int(sys.argv[2]) if len(sys.argv) > 2 else 20
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, size=(b, 512, 512, 3), dtype=np.uint8)
    mp = b * 512 * 512 / 1e6

    rows = []
    for n in (1, len(jax.devices())):
        m = pmesh.make_mesh(jax.devices()[:n])
        streams, mp_psum = pmesh.encode_batch_sharded(m, imgs[:n], q)
        t0 = time.perf_counter()
        streams, mp_psum = pmesh.encode_batch_sharded(m, imgs, q)
        dt = time.perf_counter() - t0
        assert abs(mp_psum - mp) < 1e-3
        rows.append((n, dt, mp / dt))
        print(f"devices={n:2d}  wall={dt:7.2f}s  {mp / dt:6.2f} MP/s "
              f"(psum mp={mp_psum:.3f})")

    assert streams[0] == encoder.encode(imgs[0], q), "byte mismatch"
    eff = rows[-1][2] / rows[0][2]
    print(f"sharding overhead factor (8 virtual vs 1, same cores): "
          f"{eff:.2f}x")

    # decode back end + requant tail, batch-sharded (device programs
    # only — the quality-independent synthesis/ladder stages)
    from jax.sharding import NamedSharding, PartitionSpec as P

    from nhwcodec_tpu.models import device_decode as dd
    from nhwcodec_tpu.models import device_requant as drq

    coeff = rng.integers(-900, 900, size=(b, 512, 512)).astype(np.int16)
    proc = (coeff >> 1).astype(np.int16)
    r256 = (coeff[:, :256, :256] >> 3).astype(np.int16)
    idx = np.zeros((b, 8), np.int32)
    dl = np.zeros((b, 8), np.int16)
    for n in (1, len(jax.devices())):
        m = pmesh.make_mesh(jax.devices()[:n])
        sh = NamedSharding(m, P("data"))
        f1 = jax.jit(dd.y_stage1_device,
                     in_shardings=(sh, sh, sh), out_shardings=sh)
        f2 = jax.jit(drq.requant_tail_device,
                     in_shardings=(sh, sh, sh),
                     out_shardings=(sh, sh, sh))
        args1 = (jax.device_put(coeff, sh), jax.device_put(idx, sh),
                 jax.device_put(dl, sh))
        args2 = (jax.device_put(coeff, sh), jax.device_put(proc, sh),
                 jax.device_put(r256, sh))
        np.asarray(f1(*args1))
        jax.block_until_ready(f2(*args2))
        t0 = time.perf_counter()
        o1 = f1(*args1)
        o2 = f2(*args2)
        jax.block_until_ready((o1, o2))
        dt = time.perf_counter() - t0
        print(f"decode-stage1 + requant-tail sharded: devices={n:2d} "
              f"wall={dt:6.3f}s  {mp / dt:6.1f} MP/s")


if __name__ == "__main__":
    main()
