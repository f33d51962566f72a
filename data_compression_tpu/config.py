"""Codec configuration.

The reference hard-codes every knob at compile time
(``compressed_symbols`` = 3 at n_ary_huffman.c:2529, ``#define
num_contexts``/``letters_per_context`` at nybble_compression.c:515-516,
block size 65,000 at n_ary_huffman.c:2513).  Here they are a runtime
dataclass so one build serves every configuration.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

# Stable on-the-wire codec ids (framing.py writes these into the header).
CODEC_IDS = {
    "literal": 0,
    "nybble": 1,
    "small_byte": 2,
    "small_nybble": 3,
    "huffman": 4,
}
CODEC_NAMES = {v: k for k, v in CODEC_IDS.items()}

# Default block size. The reference streams stdin in 65,000-byte blocks
# (n_ary_huffman.c:2513); we use 64 KiB so blocks tile exactly into
# power-of-two chunks on device.
DEFAULT_BLOCK_SIZE = 64 * 1024

# Default chunk: the unit of intra-block parallelism for Huffman
# encode/decode. Each chunk's payload starts byte-aligned. 512 makes a
# 64 KiB block exactly 128 chunks — one program of the GPU decode
# kernel (ops/decode_kernel.py), one thread per chunk.
DEFAULT_CHUNK_SYMS = 512

# Huffman code lengths must stay below 16 digits; the reference asserts
# the same bound (n_ary_huffman.c:1414).
MAX_CODE_LEN = 15

# Arities with bit-field wire packing and device/native fast paths
# (1-bit / 2-bit-trit / 4-bit fields).  Any other n in [2, 64] rides
# the generic host path — the reference's own experiments cover 9- and
# 10-ary (n_ary_huffman.c:1161-1208 is generic over compressed_symbols).
FAST_ARITIES = (2, 3, 16)
MAX_ARITY = 64


def _digits_per_byte(n: int) -> int:
    """Largest D with n**D <= 256: the wire packs D base-n digits per
    byte little-endian (generalizes the reference's 5-trits-per-byte
    note, n_ary_huffman.c:745-753)."""
    d = 1
    while n ** (d + 1) <= 256:
        d += 1
    return d


def _arity_cap(n: int) -> int:
    """Length cap: code values and scaled decode windows must fit in
    int32 on device (JAX's int64 is off by default): n^cap < 2^31; and
    the global MAX_CODE_LEN mirrors the reference's < 16 assertion."""
    cap = 1
    while n ** (cap + 1) < 2**31:
        cap += 1
    return min(cap, MAX_CODE_LEN)


# n=2 -> 15 / 8 bits-per-byte; n=3 -> 15 / 5 trits; n=16 -> 7 / 2
# nybbles (identical to the hand-derived round-1 values); filled for
# every supported arity so the generic host path needs no special case.
ARITY_MAX_LEN = {n: _arity_cap(n) for n in range(2, MAX_ARITY + 1)}
ARITY_DIGITS_PER_BYTE = {n: _digits_per_byte(n) for n in range(2, MAX_ARITY + 1)}


@dataclasses.dataclass(frozen=True)
class CodecConfig:
    """Runtime configuration for a codec instance.

    Attributes:
      codec: codec family name (key of CODEC_IDS).
      arity: n for n-ary Huffman (2, 3, or 16). Ignored by other codecs.
      block_size: uncompressed bytes per independent block (sharding unit).
      chunk_syms: symbols per intra-block chunk (Huffman parallel unit).
      shared_table: if True, one Huffman table for the whole stream
        (histogram psum-reduced across devices); if False, a table per
        block.
      use_device: if True, run the vectorized JAX path; if False use the
        host (numpy) reference path.
    """

    codec: str = "huffman"
    arity: int = 2
    block_size: int = DEFAULT_BLOCK_SIZE
    chunk_syms: int = DEFAULT_CHUNK_SYMS
    shared_table: bool = False
    use_device: bool = True
    # Serial-state codecs (nybble/small): the lax.scan device paths are
    # block-parallel correctness demos, orders of magnitude slower than
    # the native C path (one scan dispatch per output byte).  They are
    # opt-in; production decode always routes native/host.
    use_scan: bool = False
    # small_byte only: emit the ISPRINT_IS_ALWAYS_LITERAL (0x1f) stream
    # for all-printable blocks — the last reserved mode of the
    # reference's algorithm enum (small_compression.c:36): printable
    # compressed bytes are always literals; every non-printable byte
    # value indexes the dictionary (161 slots/context vs 127).
    isprint_literal: bool = False
    level: Optional[int] = None  # reserved

    def __post_init__(self):
        if self.codec not in CODEC_IDS:
            raise ValueError(f"unknown codec {self.codec!r}")
        if self.codec == "huffman" and not 2 <= self.arity <= MAX_ARITY:
            raise ValueError(
                f"huffman arity must be in [2, {MAX_ARITY}], got {self.arity}"
            )
        if self.block_size <= 0 or self.block_size > 2**31:
            raise ValueError(f"bad block_size {self.block_size}")
        if self.chunk_syms <= 0 or self.block_size % self.chunk_syms:
            raise ValueError(
                f"chunk_syms {self.chunk_syms} must divide block_size {self.block_size}"
            )
        if self.codec == "huffman" and self.chunk_syms & (self.chunk_syms - 1):
            raise ValueError("huffman chunk_syms must be a power of two")

    @property
    def codec_id(self) -> int:
        return CODEC_IDS[self.codec]
