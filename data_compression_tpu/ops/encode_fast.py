"""Scatter-free Huffman encode: hierarchical bit-buffer merge.

The v1 encoder (ops/huffman_coding.py) places each output digit with a
scatter-add + cumsum over a [N, cap] digit grid.  This formulation uses
only elementwise ops, static pads / slices, selects, and one table
gather per symbol, which XLA fuses into a few memory-bound loops:

  * each symbol's code becomes a little-endian *bit-field* word: digit
    m (stream order) occupies field m of width bpd bits (bpd = 1 for
    n=2, 2 for n=3 — trits ride 2-bit fields, 4 for n=16);
  * adjacent (buffer, bitlen) pairs merge up a binary tree:
    ``out = a | shift_left(b, a_len)``, log2(C) levels; a multiword
    variable shift is log2(W) conditional one-word static shifts (the
    binary decomposition of the word offset) plus one elementwise bit
    shift with carry — no gather, no scatter;
  * the final buffer reinterprets directly as the v1 wire bytes for
    n=2/16; for n=3 the 2-bit fields are repacked to the 5-trits-per-
    byte wire format (n_ary_huffman.c:745-753) in one elementwise pass.

Byte-for-byte identical to the v1 encoder and the numpy oracle
(tests/test_encode_fast.py).  ``encode_blocks_compact`` is the device
encode of every entry point: this merge tree and ops/compaction in one
jit, so only compressed bytes leave the device.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from data_compression_tpu.config import ARITY_DIGITS_PER_BYTE, ARITY_MAX_LEN
from data_compression_tpu.huffman.canonical import CanonicalTable
from data_compression_tpu.ops.compaction import compact_rows
from data_compression_tpu.ops.huffman_coding import _cap_digits

BITS_PER_DIGIT = {2: 1, 3: 2, 16: 4}


def pack_encode_table(table: CanonicalTable) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side: per symbol, the little-endian field-packed code word
    and its bit-field length.  [S] uint32, [S] int32.  Vectorized: digit
    m (MSB-first stream order) lands in field m of width bpd."""
    n = table.arity
    bpd = BITS_PER_DIGIT[n]
    lens = np.asarray(table.lengths, np.int64)
    codes = np.asarray(table.codes, np.int64)
    maxlen = int(lens.max(initial=0))
    packed = np.zeros(lens.shape[0], np.uint64)
    for m in range(maxlen):
        place = np.clip(lens - 1 - m, 0, None)
        digit = (codes // n**place) % n
        packed |= np.where(m < lens, digit << (m * bpd), 0).astype(np.uint64)
    return packed.astype(np.uint32), (lens * bpd).astype(np.int32)


def _shift_words_right(x: jnp.ndarray, k: int) -> jnp.ndarray:
    """Move word i to word i+k (towards higher indices), zero-fill low."""
    if k == 0:
        return x
    W = x.shape[-1]
    if k >= W:
        return jnp.zeros_like(x)
    pad = [(0, 0)] * (x.ndim - 1) + [(k, 0)]
    return jnp.pad(x, pad)[..., :W]


def _multiword_shl(b: jnp.ndarray, nbits: jnp.ndarray) -> jnp.ndarray:
    """Shift each row of b [..., W] left (towards higher bit positions /
    higher words) by nbits [...] (a per-row scalar)."""
    W = b.shape[-1]
    wsh = (nbits >> 5)[..., None]
    bsh = (nbits & 31)[..., None].astype(jnp.uint32)
    x = b
    t = 0
    while (1 << t) < W:
        moved = _shift_words_right(x, 1 << t)
        x = jnp.where((wsh >> t) & 1 == 1, moved, x)
        t += 1
    prev = _shift_words_right(x, 1)
    lo = x << bsh
    carry = jnp.where(
        bsh == 0, jnp.uint32(0), prev >> (jnp.uint32(32) - bsh)
    )
    return lo | carry


@functools.partial(jax.jit, static_argnames=("arity", "chunk_syms"))
def encode_chunks_fast(
    syms: jnp.ndarray,  # [N, C]
    counts: jnp.ndarray,  # [N]
    packed_tab: jnp.ndarray,  # [T, S] uint32
    bits_tab: jnp.ndarray,  # [T, S] int32
    tbl_of_chunk: jnp.ndarray,  # [N]
    *,
    arity: int,
    chunk_syms: int,
):
    """-> (packed bytes [N, max_bytes], nbytes [N], ndigits [N]);
    wire-identical to ops.huffman_coding.encode_chunks."""
    N, C = syms.shape
    assert C == chunk_syms and (C & (C - 1)) == 0, "chunk_syms must be a power of 2"
    bpd = BITS_PER_DIGIT[arity]
    D = ARITY_DIGITS_PER_BYTE[arity]
    maxf = ARITY_MAX_LEN[arity] * bpd  # max bit-field length per symbol
    cap_digits = _cap_digits(C, arity)
    cap_bits = cap_digits * bpd
    Wf = -(-cap_bits // 32)

    syms = syms.astype(jnp.int32)
    valid = jnp.arange(C)[None, :] < counts[:, None]
    words = packed_tab[tbl_of_chunk[:, None], syms][..., None]  # [N, C, 1] u32
    lens = jnp.where(valid, bits_tab[tbl_of_chunk[:, None], syms], 0)  # bits
    words = jnp.where(valid[..., None], words, jnp.uint32(0))

    P, W = C, 1
    level = 0
    while P > 1:
        level += 1
        need_bits = min((1 << level) * maxf, cap_bits)
        W2 = min(-(-need_bits // 32), Wf)
        a, b = words[:, 0::2], words[:, 1::2]
        la, lb = lens[:, 0::2], lens[:, 1::2]
        if W2 > W:
            padw = [(0, 0), (0, 0), (0, W2 - W)]
            a = jnp.pad(a, padw)
            b = jnp.pad(b, padw)
        words = a | _multiword_shl(b, la)
        lens = la + lb
        P //= 2
        W = W2

    buf = words[:, 0]  # [N, Wf] uint32
    total_bits = lens[:, 0]
    total_digits = total_bits // bpd
    out = words_to_wire_bytes(buf, arity, cap_digits)
    nbytes = -(-total_digits // D)
    return out, nbytes, total_digits


def words_to_wire_bytes(buf: jnp.ndarray, arity: int, cap_digits: int) -> jnp.ndarray:
    """[N, Wf] u32 bit-field buffers -> [N, max_bytes] wire bytes
    (identity reinterpretation for n=2/16; 2-bit fields -> 5 trits per
    byte for n=3)."""
    N, Wf = buf.shape
    buf = buf.astype(jnp.uint32)
    D = ARITY_DIGITS_PER_BYTE[arity]
    if arity == 3:
        shifts = (2 * jnp.arange(16, dtype=jnp.uint32))[None, None, :]
        trits = ((buf[:, :, None] >> shifts) & 3).astype(jnp.int32)  # [N, Wf, 16]
        trits = trits.reshape(N, Wf * 16)[:, :cap_digits]
        weights = jnp.asarray([1, 3, 9, 27, 81], jnp.int32)
        return jnp.sum(
            trits.reshape(N, cap_digits // 5, 5) * weights[None, None, :], axis=-1
        ).astype(jnp.uint8)
    shifts = (8 * jnp.arange(4, dtype=jnp.uint32))[None, None, :]
    out = ((buf[:, :, None] >> shifts) & jnp.uint32(0xFF)).astype(jnp.uint8)
    return out.reshape(N, Wf * 4)[:, : cap_digits // D]


@functools.partial(
    jax.jit, static_argnames=("arity", "chunk_syms", "out_cap")
)
def encode_blocks_compact(
    blocks: jnp.ndarray,  # [B, S] uint8
    lengths: jnp.ndarray,  # [B] valid bytes per block
    packed_tab: jnp.ndarray,  # [B, 256] uint32 (pack_encode_table)
    bits_tab: jnp.ndarray,  # [B, 256] int32
    *,
    arity: int,
    chunk_syms: int,
    out_cap: int,
):
    """Encode every chunk of every block and compact the payloads.
    -> (flat [out_cap] uint8 wire bytes in chunk order, nbytes [B, S/C]
    int32 per-chunk wire bytes).  ``out_cap`` must be >= the total."""
    B, S = blocks.shape
    C = chunk_syms
    ncb = S // C
    counts = jnp.clip(
        lengths.astype(jnp.int32)[:, None]
        - jnp.arange(ncb, dtype=jnp.int32)[None, :] * C,
        0,
        C,
    ).reshape(-1)
    tbl_of_chunk = jnp.repeat(jnp.arange(B, dtype=jnp.int32), ncb)
    packed, nbytes, _ = encode_chunks_fast(
        blocks.reshape(B * ncb, C), counts, packed_tab, bits_tab,
        tbl_of_chunk, arity=arity, chunk_syms=C,
    )
    return compact_rows(packed, nbytes, out_cap), nbytes.reshape(B, ncb)
