"""Device-code checkify job (SURVEY.md section 5, race/sanitizer row).

Runs the decode transform under jax.experimental.checkify with index and
NaN checks enabled — the JAX-native analog of running device kernels
under a sanitizer.  CPU backend in a subprocess (backend-agnostic)."""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

_CODE = """
import numpy as np
import jax
from jax.experimental import checkify
from nhwcodec_tpu.models.transform import decode_transform

rng = np.random.default_rng(0)
y = rng.integers(-2000, 2000, size=(2, 512, 512)).astype(np.int16)
u = rng.integers(-2000, 2000, size=(2, 256, 256)).astype(np.int16)
v = rng.integers(-2000, 2000, size=(2, 256, 256)).astype(np.int16)

checked = checkify.checkify(
    decode_transform, errors=checkify.index_checks | checkify.nan_checks)
err, out = jax.jit(checked)(y, u, v)
err.throw()  # no OOB indexing / NaNs anywhere in the device pipeline
assert out.shape == (2, 512, 512, 3)
print("OK")
"""


def test_decode_transform_checkify_clean():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "-c", _CODE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    assert "OK" in out.stdout
