"""data_compression_tpu — a lossless codec family in JAX.

A JAX/XLA framework, with a Pallas (Triton) decode kernel for NVIDIA
GPUs, reproducing the capabilities of the reference repo
``carycode/data_compression`` (three codec families: n-ary canonical
Huffman, 16-context MTF nybble packing, and context-keyed LZW "small"
codecs), re-designed for data-parallel devices:

* inputs are split into independent fixed-size blocks laid out as
  ``[num_blocks, block_size]`` and sharded data-parallel over a
  ``jax.sharding.Mesh`` (the reference is single-threaded stdin C);
* within a block, fixed-size *chunks* encode/decode independently and
  byte-aligned so variable-length emission vectorizes (gather +
  prefix-sum + searchsorted digit placement — no serial bit cursor);
* canonical n-ary code tables are built on host (tiny problem) and
  broadcast to devices;
* an exact binary framing header (magic/version/block table/CRC) makes
  every stream self-describing and binary-safe, unlike the reference's
  NUL-terminated C strings.

Reference parity: see SURVEY.md. The nybble codec core is bit-exact with
/root/reference/nybble_compression.c (the only fully-working reference
codec); Huffman table construction matches the reference's canonical
convention and unit-test vectors (n_ary_huffman.c:2821-2891) with its
dummy-node bug (n_ary_huffman.c:900-916) fixed; the Huffman bitstream is
our own design because the reference's emission is stubbed
(n_ary_huffman.c:1661,1786).
"""

from data_compression_tpu.api import (
    compress,
    decompress,
    compress_file,
    decompress_file,
    roundtrip,
)
from data_compression_tpu.config import CodecConfig, CODEC_IDS
from data_compression_tpu.registry import get_codec, register_codec, available_codecs

__version__ = "0.1.0"

__all__ = [
    "compress",
    "decompress",
    "compress_file",
    "decompress_file",
    "roundtrip",
    "CodecConfig",
    "CODEC_IDS",
    "get_codec",
    "register_codec",
    "available_codecs",
    "__version__",
]
