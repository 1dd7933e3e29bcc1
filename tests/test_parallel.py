"""Multi-device sharding tests on a virtual CPU mesh.

The virtual device count must be configured before JAX initializes, so
these tests run in a subprocess (SURVEY.md section 4: multi-device testing
without a multi-card host).
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

_DP_EQUIVALENCE = """
import numpy as np, jax
from nhwcodec_tpu.parallel import mesh as pmesh
from nhwcodec_tpu.models.transform import decode_transform

assert len(jax.devices()) == 8, jax.devices()
rng = np.random.default_rng(42)
b = 16
y = rng.integers(-2000, 2000, size=(b, 512, 512)).astype(np.int16)
u = rng.integers(-2000, 2000, size=(b, 256, 256)).astype(np.int16)
v = rng.integers(-2000, 2000, size=(b, 256, 256)).astype(np.int16)

m = pmesh.make_mesh()
ys, us, vs = pmesh.shard_batch(m, y, u, v)
rgb_sharded, mp = pmesh.decode_batch_step(m, ys, us, vs)

rgb_single = decode_transform(y, u, v)
np.testing.assert_array_equal(np.asarray(rgb_sharded), np.asarray(rgb_single))
assert abs(float(mp) - b * 512 * 512 / 1e6) < 1e-6
print("OK")
"""


def _run_on_cpu_mesh(code: str, n: int = 8) -> str:
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n}"
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    return out.stdout


def test_dp_sharded_decode_matches_single_device():
    """DP sharding of a batch is bytewise identical to unsharded compute."""
    assert "OK" in _run_on_cpu_mesh(_DP_EQUIVALENCE)


def test_graft_dryrun_multichip():
    code = "import __graft_entry__ as g; g.dryrun_multichip(8); print('OK')"
    assert "OK" in _run_on_cpu_mesh(code)
