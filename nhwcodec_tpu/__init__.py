"""nhwcodec_tpu — the NHW image codec with its plane transforms on an
accelerator.

A from-scratch JAX/XLA re-design of the NHW codec (reference:
rcanut/nhwcodec, a single-threaded C implementation).  Lossy compression of
512x512 24-bit RGB images via a 2-level integer 5/3-style lifting wavelet
transform, scalar quantization with pattern-coded special words, positional
residue side-streams and a static-Huffman entropy coder.

Architecture (device-first, not a port):

- ``ops``      device kernels: lifting filterbanks, colorspace, deringing,
               upsampling — vectorized over whole planes and batched with
               ``vmap``; bit-exact int16 semantics.
- ``models``   the encode/decode pipelines orchestrating ops + streams.
- ``parallel`` ``jax.sharding.Mesh`` data-parallel batch encode/decode.
- ``utils``    host-side container (.nhw) layout, BMP I/O, fixtures.
- ``tables``   the format constants (Huffman code tables, quality tables).

Bit-exactness contract: decoding any valid ``.nhw`` file produces output
byte-identical to the reference ``nhw-dec`` at every quality level q1..q23.
"""

from nhwcodec_tpu.version import __version__
from nhwcodec_tpu.models.decoder import decode, decode_to_bmp
from nhwcodec_tpu.models.encoder import encode, encode_bmp

__all__ = ["__version__", "decode", "decode_to_bmp", "encode", "encode_bmp"]
