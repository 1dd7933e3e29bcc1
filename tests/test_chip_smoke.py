"""chip_smoke.py: refuses to run without a GPU, and its phases hold the
device paths to the host codec (here at batch 2 on the CPU backend)."""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent


def test_refuses_cpu_backend():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_images_seeded_and_distinct():
    import chip_smoke

    a = chip_smoke.make_images(3, 16)
    assert a.shape == (16, 512, 512, 3) and a.dtype == np.uint8
    assert np.array_equal(a, chip_smoke.make_images(3, 16))
    assert not np.array_equal(a, chip_smoke.make_images(4, 16))


def test_encode_phase_batch2():
    import chip_smoke

    imgs = chip_smoke.make_images(0, 2)
    streams = chip_smoke.phase_encode(imgs, 20)
    assert len(streams) == 2


def test_colorspace_phase_two_planes():
    import chip_smoke

    chip_smoke.phase_colorspace(chip_smoke.all_triples()[::32][:2], 20)
