"""E6 block_variance_avg vs an oracle build with the dead call
re-enabled.

The reference comments the call out (encoder/nhw_encoder.c:112), so the
flag-gated implementation is validated against an instrumented build
(tools/oracle.build_bva) that restores it, under the deterministic
zero-filled-malloc preload.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
import oracle  # noqa: E402

from nhwcodec_tpu.models import encoder  # noqa: E402
from nhwcodec_tpu.utils import bmp, fixtures  # noqa: E402
from nhwcodec_tpu.utils.container import equal_modulo_dead_bits  # noqa: E402

pytestmark = pytest.mark.skipif(not oracle.available(),
                                reason="reference sources unavailable")


@pytest.mark.parametrize("q", [6, 9, 12, 14])
def test_block_variance_encode_matches_bva_oracle(q, tmp_path):
    for name, gen in (("flat", fixtures.near_flat),
                      ("grad", fixtures.gradient_circles),
                      ("tex", fixtures.texture_noise)):
        img = gen()
        p = tmp_path / f"{name}.bmp"
        bmp.write_bmp512(p, img)
        ref = tmp_path / "ref.nhw"
        oracle.encode_bva_det(p, ref, q)
        ours = encoder.encode(img, q, block_variance=True)
        assert equal_modulo_dead_bits(ours, ref.read_bytes()), (name, q)


def test_block_variance_noop_above_low6(tmp_path):
    """The reference's intended gate is q <= LOW6 (=14): above it the
    flag must not change the stream."""
    img = fixtures.gradient_circles()
    assert encoder.encode(img, 20, block_variance=True) == \
        encoder.encode(img, 20)


def test_block_variance_changes_low_q_stream():
    """Smoothable content at q <= LOW6 must actually flow through the
    smoother (guards against the flag silently doing nothing)."""
    img = fixtures.near_flat()
    assert encoder.encode(img, 14, block_variance=True) != \
        encoder.encode(img, 14)
