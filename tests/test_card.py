"""Device-vs-host equality on a GPU card at real shapes.

Marked ``card``: each test skips unless JAX's default device is a GPU
(decided in the ``gpu_card`` fixture, at test time).  On a card:
``python -m pytest tests/test_card.py -m card``.
"""

from __future__ import annotations

import pytest


@pytest.mark.card
def test_device_encode_decode_batch8_on_card(gpu_card):
    import chip_smoke

    imgs = chip_smoke.make_images(1, 8)
    streams = chip_smoke.phase_encode(imgs, 20)
    chip_smoke.phase_decode(streams)


@pytest.mark.card
def test_exact_colorspace_on_card(gpu_card):
    import chip_smoke

    planes = chip_smoke.all_triples()[:8]
    for q in (20, 9):
        chip_smoke.phase_colorspace(planes, q)
