"""The native host runtime builds and loads with the standard library
alone (cc + ctypes): no cffi needed."""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

_CODE = """
import hashlib, sys
{block}
from nhwcodec_tpu import native
from nhwcodec_tpu.models import encoder
from nhwcodec_tpu.utils import fixtures
print(native.available())
print(hashlib.sha256(encoder.encode(fixtures.sharp_blocks(), 20)).hexdigest())
"""


def _run(native_on: str, block: str) -> list[str]:
    env = dict(os.environ, JAX_PLATFORMS="cpu", NHW_NATIVE=native_on)
    r = subprocess.run([sys.executable, "-c", _CODE.format(block=block)],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout.split()


def test_native_loads_without_cffi_and_matches_python():
    # a None entry in sys.modules makes every `import cffi` fail
    loaded, digest = _run("1", "sys.modules['cffi'] = None")
    assert loaded == "True"
    off, want = _run("0", "")
    assert off == "False"
    assert digest == want
