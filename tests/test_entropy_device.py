"""Device prefix-sum bit packer equals the sequential reference packer.

Runs on the CPU backend in a subprocess: the packer is backend-agnostic
XLA.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

_CODE = """
import numpy as np
from nhwcodec_tpu import tables as T
from nhwcodec_tpu.ops import entropy_device
from nhwcodec_tpu.ops.entropy_enc import _BitPacker

rng = np.random.default_rng(42)
pos = rng.integers(0, 290, size=5000)
codes = T.HUFFMAN_CODES[pos].astype(np.uint32)
lens = T.HUFFMAN_LENS[pos].astype(np.int32)
seq = _BitPacker()
for c, l in zip(codes.tolist(), lens.tolist()):
    seq.put(int(c), int(l))
n_words = seq.a + 1
want = np.array(seq.words[:n_words], np.uint32)
got = np.asarray(entropy_device.pack_bits_device_jit(codes, lens, n_words))
np.testing.assert_array_equal(got, want)

pos = rng.integers(0, 354, size=2000)
zone = (pos >= 110) & (pos < 174)
seq = _BitPacker()
bits = 0
for p, z in zip(pos.tolist(), zone.tolist()):
    if z:
        seq.put((1 << 6) | (p - 110), 15)
        bits += 15
    else:
        pp = p - 64 if p >= 174 else p
        seq.put(int(T.HUFFMAN_CODES[pp]), int(T.HUFFMAN_LENS[pp]))
        bits += int(T.HUFFMAN_LENS[pp])
n_words = seq.a + 1
want = np.array(seq.words[:n_words], np.uint32)
got, nbits = entropy_device.tokens_to_words(pos.astype(np.int32), True,
                                            n_words)
np.testing.assert_array_equal(got, want)
assert nbits == bits

# zone-off stream: positions index the code table directly
pos = rng.integers(0, 290, size=1500)
seq = _BitPacker()
for p in pos.tolist():
    seq.put(int(T.HUFFMAN_CODES[p]), int(T.HUFFMAN_LENS[p]))
n_words = seq.a + 1
want = np.array(seq.words[:n_words], np.uint32)
got, _ = entropy_device.tokens_to_words(pos.astype(np.int32), False,
                                        n_words)
np.testing.assert_array_equal(got, want)

# padding mask emits nothing
pos_p = np.zeros(4096, np.int32)
pos_p[:1500] = pos
valid = np.zeros(4096, bool); valid[:1500] = True
got2, _ = entropy_device.tokens_to_words(pos_p, False, n_words, valid=valid)
np.testing.assert_array_equal(got2, want)
print("OK")
"""


def test_pack_bits_device_matches_sequential_cpu():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "-c", _CODE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    assert "OK" in out.stdout


def test_device_pack_full_encode_byte_identical():
    """The device prefix-sum packer inside the real encode: byte-equal
    .nhw files across qualities."""
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    code = (
        "import numpy as np\n"
        "from nhwcodec_tpu.models import encoder\n"
        "from nhwcodec_tpu.utils import fixtures\n"
        "rng = np.random.default_rng(5)\n"
        "imgs = {'grad': fixtures.gradient_circles(),"
        " 'rand': rng.integers(0, 256, (512,512,3), dtype=np.uint8)}\n"
        "for name, img in imgs.items():\n"
        "    for q in (23, 20, 8):\n"
        "        a = encoder.encode(img, q)\n"
        "        b = encoder.encode_device(img, q, device_pack=True)\n"
        "        assert a == b, (name, q)\n"
        "print('OK')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    assert "OK" in out.stdout
