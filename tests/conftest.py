"""Test fixtures: golden-oracle binaries + synthetic corpora, and the
``card`` marker's fixture.

Multi-device sharding tests run on a virtual CPU mesh
(``--xla_force_host_platform_device_count``) in subprocesses.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))


def _enable_compile_cache() -> None:
    """Persistent XLA compile cache for the suite: the device-path
    programs (chain extraction, chunked fixpoint, device decode) cost
    minutes to compile on XLA:CPU at real shapes; cached they replay in
    milliseconds on every later run.  Exported through the environment
    too, so subprocess-based tests share it."""
    from nhwcodec_tpu.utils.compile_cache import enable_compile_cache

    d = enable_compile_cache()
    os.environ.setdefault("JAX_COMPILATION_CACHE_DIR", d)
    os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES",
                          "-1")
    os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS",
                          "1")


_enable_compile_cache()

import oracle  # noqa: E402
from nhwcodec_tpu.utils import bmp, fixtures  # noqa: E402

requires_oracle = pytest.mark.skipif(
    not oracle.available(), reason="reference sources not available"
)


@pytest.fixture(scope="session")
def oracle_bins():
    if not oracle.available():
        pytest.skip("reference sources not available")
    return oracle.build()


@pytest.fixture(scope="session")
def fixture_dir(oracle_bins) -> Path:
    """Build (and cache) the synthetic BMP corpus under .oracle/fixtures."""
    d = oracle.FIXTURES
    d.mkdir(parents=True, exist_ok=True)
    for name, gen in fixtures.GENERATORS.items():
        p = d / f"{name}.bmp"
        if not p.exists():
            bmp.write_bmp512(p, gen())
    return d


def golden(fixture_dir: Path, name: str, q: int) -> tuple[Path, Path]:
    """Return (nhw_path, decoded_bmp_path) for image `name` at quality q,
    encoding/decoding with the oracle on first use (cached on disk)."""
    src = fixture_dir / f"{name}.bmp"
    nhw = fixture_dir / f"{name}_q{q}.nhw"
    dec = fixture_dir / f"{name}_q{q}_dec.bmp"
    if not nhw.exists():
        oracle.encode(src, nhw, q)
    if not dec.exists():
        oracle.decode(nhw, dec)
    return nhw, dec


@pytest.fixture(scope="session")
def golden_q20(fixture_dir):
    return {name: golden(fixture_dir, name, 20) for name in fixtures.GENERATORS}


def load_bmp_bytes(path: Path) -> np.ndarray:
    return np.frombuffer(path.read_bytes(), dtype=np.uint8)


@pytest.fixture
def gpu_card():
    """For tests marked ``card``: skip unless JAX's default device is a
    GPU.  Decided here, at test time, never while modules are imported
    (every xdist worker must collect the same tests)."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU card (default device: {dev.platform})")
    return dev
