"""Batched canonical-table construction: all blocks at once.

Round-3 profile showed per-block Python table building (huffman/tree.py
+ canonical.lengths_to_codes, ~190 us/block) costing ~0.2 s per 64 MiB
— longer than the encode kernel itself.  This module vectorizes every
host table stage across the block axis:

  * ``capped_lengths_batch``: [B, 256] histograms -> [B, 256] code
    lengths via the native C two-queue builder (OpenMP across blocks,
    ~20 us/block single-thread; bit-identical to huffman/tree.py —
    differential-tested), with a pure-Python fallback.
  * ``codes_batch``: batched canonical assignment — the same
    shortest-to-longest, symbol-order convention as
    canonical.lengths_to_codes (n_ary_huffman.c:1382-1612), as [B, ...]
    array ops.
  * ``packed_rows`` / ``decode_rows``: the encode- and decode-side
    device table layouts, batched.

`TableBatch.table(i)` adapts one row back to a `CanonicalTable` for the
per-block host paths, guaranteeing a single source of truth.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from data_compression_tpu.config import ARITY_MAX_LEN
from data_compression_tpu.huffman.canonical import CanonicalTable
from data_compression_tpu.huffman.tree import huffman_lengths


def capped_lengths_batch(hists: np.ndarray, arity: int) -> np.ndarray:
    """[B, S] histograms -> [B, S] int32 canonical code lengths under
    the per-arity cap (halving rescale, models/huffman.capped_lengths
    semantics)."""
    hists = np.ascontiguousarray(hists, np.int64)
    cap = ARITY_MAX_LEN[arity]
    from data_compression_tpu import native

    if hists.shape[1] <= 256:
        out = native.huffman_capped_lengths_batch(hists, arity, cap)
        if out is not None:
            return out
    out = np.empty(hists.shape, np.int32)
    for i in range(hists.shape[0]):
        f = hists[i]
        while True:
            lens = huffman_lengths(f, arity, max_len=64)
            if lens.max(initial=0) <= cap:
                break
            f = np.where(f > 0, (f + 1) // 2, 0)
        out[i] = lens
    return out


@dataclasses.dataclass
class TableBatch:
    """Per-block canonical tables as stacked arrays (see
    canonical.CanonicalTable for field meaning; L = ARITY_MAX_LEN)."""

    arity: int
    lengths: np.ndarray  # [B, S] int32
    codes: np.ndarray  # [B, S] int64
    first_code: np.ndarray  # [B, L+1] int64
    count: np.ndarray  # [B, L+1] int64
    base_index: np.ndarray  # [B, L+1] int64
    sorted_symbols: np.ndarray  # [B, S] int32, zero-padded past n_used
    n_used: np.ndarray  # [B] int32
    max_len: np.ndarray  # [B] int32

    @property
    def num_blocks(self) -> int:
        return self.lengths.shape[0]

    def table(self, i: int) -> CanonicalTable:
        """Row i as a CanonicalTable (trimmed to its own max_len)."""
        ml = int(self.max_len[i])
        used = self.lengths[i] > 0
        min_len = int(self.lengths[i][used].min()) if used.any() else 0
        return CanonicalTable(
            arity=self.arity,
            lengths=self.lengths[i],
            codes=self.codes[i],
            first_code=self.first_code[i, : ml + 1],
            count=self.count[i, : ml + 1],
            base_index=self.base_index[i, : ml + 1],
            sorted_symbols=self.sorted_symbols[i, : int(self.n_used[i])].astype(
                np.int64
            ),
            max_len=ml,
            min_len=min_len,
        )

    def table_bytes(self) -> np.ndarray:
        """[B, S] uint8 — each row is CanonicalTable.to_bytes()."""
        return self.lengths.astype(np.uint8)


def codes_batch(lengths: np.ndarray, arity: int) -> TableBatch:
    """Batched canonical code assignment, row-identical to
    canonical.lengths_to_codes (differential-tested)."""
    lengths = np.ascontiguousarray(lengths, np.int32)
    B, S = lengths.shape
    L = ARITY_MAX_LEN[arity]
    used = lengths > 0
    if lengths.max(initial=0) > L:
        raise ValueError(f"code length {lengths.max()} exceeds {L}")

    # count[b, l] = symbols of length l (l in 0..L)
    count = np.zeros((B, L + 1), np.int64)
    for ln in range(1, L + 1):
        count[:, ln] = (lengths == ln).sum(axis=1)

    # canonical recurrence f[l+1] = (f[l] + count[l]) * n; zero counts
    # below min_len keep f at 0, matching the per-block loop start
    first_code = np.zeros((B, L + 1), np.int64)
    for ln in range(1, L):
        first_code[:, ln + 1] = (first_code[:, ln] + count[:, ln]) * arity
    # Kraft validation: codes of length l must fit below n^l
    acc = np.int64(1)
    for ln in range(1, L + 1):
        acc = acc * arity
        bad = first_code[:, ln] + count[:, ln] > acc
        if bad.any():
            raise ValueError(
                f"length table violates Kraft inequality (block {int(np.flatnonzero(bad)[0])})"
            )

    base_index = np.zeros((B, L + 1), np.int64)
    np.cumsum(count[:, :-1], axis=1, out=base_index[:, 1:])

    # symbols sorted by (length, symbol): stable argsort with unused
    # pushed past the end
    sort_key = np.where(used, lengths, np.int32(L + 1))
    order = np.argsort(sort_key, axis=1, kind="stable").astype(np.int32)
    n_used = used.sum(axis=1).astype(np.int32)
    pos = np.arange(S, dtype=np.int64)[None, :]
    valid = pos < n_used[:, None]

    ln_of = np.take_along_axis(lengths, order, axis=1).astype(np.int64)
    ln_cl = np.clip(ln_of, 0, L)
    group_start = np.take_along_axis(base_index, ln_cl, axis=1)
    rank = pos - group_start
    codes_sorted = np.take_along_axis(first_code, ln_cl, axis=1) + rank
    codes = np.zeros((B, S), np.int64)
    np.put_along_axis(
        codes, order.astype(np.int64), np.where(valid, codes_sorted, 0), axis=1
    )

    sorted_symbols = np.where(valid, order, 0).astype(np.int32)
    return TableBatch(
        arity=arity,
        lengths=lengths,
        codes=codes,
        first_code=first_code,
        count=count,
        base_index=base_index,
        sorted_symbols=sorted_symbols,
        n_used=n_used,
        max_len=lengths.max(axis=1).astype(np.int32),
    )


def tables_from_bytes(rows: np.ndarray, arity: int) -> TableBatch:
    """[B, S] uint8 wire length rows -> TableBatch (the batched
    CanonicalTable.from_bytes)."""
    return codes_batch(np.ascontiguousarray(rows).astype(np.int32), arity)


def packed_rows(tb: TableBatch):
    """Batched ops.encode_fast.pack_encode_table: per-symbol
    little-endian field-packed code words.  -> ([B, S] uint32 packed,
    [B, S] int32 field-bit lengths)."""
    from data_compression_tpu.ops.encode_fast import BITS_PER_DIGIT

    n = tb.arity
    bpd = BITS_PER_DIGIT[n]
    lens = tb.lengths.astype(np.int64)
    codes = tb.codes
    maxlen = int(lens.max(initial=0))
    packed = np.zeros(lens.shape, np.uint64)
    for m in range(maxlen):
        place = np.clip(lens - 1 - m, 0, None)
        digit = (codes // np.int64(n) ** place) % n
        packed |= np.where(m < lens, digit << (m * bpd), 0).astype(np.uint64)
    return packed.astype(np.uint32), (lens * bpd).astype(np.int32)


def decode_rows(tb: TableBatch, pad_to: int):
    """Batched canonical.build_decode_tables: scaled decode tables as
    stacked arrays — limit_scaled [B, L+1] int64, base_minus_first
    [B, L+1] int64, symbols [B, S] int32."""
    L = pad_to
    n = tb.arity
    B = tb.num_blocks
    lsh = min(tb.first_code.shape[1] - 1, L)
    scale = np.int64(n) ** (L - np.arange(L + 1, dtype=np.int64))
    lens_ok = (
        np.arange(L + 1, dtype=np.int64)[None, :]
        <= tb.max_len[:, None].astype(np.int64)
    )
    limit = np.zeros((B, L + 1), np.int64)
    bmf = np.zeros((B, L + 1), np.int64)
    limit[:, 1 : lsh + 1] = np.where(
        lens_ok[:, 1 : lsh + 1],
        (tb.first_code[:, 1 : lsh + 1] + tb.count[:, 1 : lsh + 1])
        * scale[None, 1 : lsh + 1],
        0,
    )
    bmf[:, 1 : lsh + 1] = np.where(
        lens_ok[:, 1 : lsh + 1],
        tb.base_index[:, 1 : lsh + 1] - tb.first_code[:, 1 : lsh + 1],
        0,
    )
    limit = np.maximum.accumulate(limit, axis=1)
    return {
        "limit_scaled": limit,
        "base_minus_first": bmf,
        "symbols": tb.sorted_symbols,
    }
