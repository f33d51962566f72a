"""n-ary canonical Huffman codec (n = 2, 3, 16).

The reference's north-star scheme (n_ary_huffman.c).  Table
construction follows the reference exactly (huffman/tree.py,
huffman/canonical.py — parity-tested against n_ary_huffman.c:2821-2891);
the bitstream is our own chunk-parallel design because the reference's
emission is stubbed (``assert(0)`` at n_ary_huffman.c:1661,:1786 — it
never produced a stream).

Block payload layout (all little-endian):

  u8   table_mode      0 = inline table, 1 = stream-shared table
  [inline only] u8[256] canonical length per symbol (the same
        information the reference's '\\nX' header carries,
        n_ary_huffman.c:1736-1741)
  u16  num_chunks
  u16  chunk_bytes[num_chunks]
  chunk payloads, each byte-aligned (digits packed per
        config.ARITY_DIGITS_PER_BYTE: 8 bits / 5 trits / 2 nybbles)

Chunks are ``chunk_syms`` consecutive symbols; per-chunk byte lengths
make decode embarrassingly parallel (the design the reference sketches
at small_compression.c:924-927).  Device encode is ops/encode_fast
(merge tree + compaction in one jit); device decode is
ops/decode_kernel.decode_chunks (the GPU kernel on a GPU, the XLA
decode elsewhere).  The numpy host path below is the bit-exact oracle
used by differential tests.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

import numpy as np

from data_compression_tpu.config import (
    ARITY_DIGITS_PER_BYTE,
    ARITY_MAX_LEN,
    FAST_ARITIES,
)
from data_compression_tpu.huffman.canonical import (
    CanonicalTable,
    build_decode_tables,
)
from data_compression_tpu.huffman.tree import huffman_lengths
from data_compression_tpu.models.base import Codec, EncodeResult


def capped_lengths(freqs: np.ndarray, arity: int) -> np.ndarray:
    """Huffman lengths under the per-arity cap; frequencies are halved
    (flattened) until the optimal tree fits, the standard rescaling
    fallback. In practice 64 KiB blocks never need it for n=2/3."""
    cap = ARITY_MAX_LEN[arity]
    freqs = np.asarray(freqs, np.int64)
    while True:
        lengths = huffman_lengths(freqs, arity, max_len=64)
        if lengths.max(initial=0) <= cap:
            return lengths
        freqs = np.where(freqs > 0, (freqs + 1) // 2, 0)


# ----------------------------------------------------------------------
# Host (numpy) oracle paths — bit-exact with ops/huffman_coding.py
# ----------------------------------------------------------------------


def encode_chunk_np(syms: np.ndarray, table: CanonicalTable) -> bytes:
    n = table.arity
    D = ARITY_DIGITS_PER_BYTE[n]
    digits: List[int] = []
    for s in syms:
        code = int(table.codes[s])
        ln = int(table.lengths[s])
        assert ln > 0, f"symbol {s} has no code"
        for p in range(ln - 1, -1, -1):
            digits.append((code // n**p) % n)
    while len(digits) % D:
        digits.append(0)
    out = bytearray()
    for k in range(0, len(digits), D):
        b = 0
        for d in range(D):
            b += digits[k + d] * n**d
        out.append(b)
    return bytes(out)


def decode_chunk_np(payload: bytes, count: int, table: CanonicalTable) -> np.ndarray:
    n = table.arity
    D = ARITY_DIGITS_PER_BYTE[n]
    digits: List[int] = []
    for b in payload:
        for d in range(D):
            digits.append((b // n**d) % n)
    out = np.empty(count, np.uint8)
    off = 0
    for i in range(count):
        value = 0
        ln = 0
        while True:
            ln += 1
            if off + ln > len(digits):
                raise ValueError("truncated huffman chunk")
            value = value * n + digits[off + ln - 1]
            if ln >= len(table.first_code):
                cnt = 0
            else:
                cnt = int(table.count[ln]) if ln < table.count.shape[0] else 0
            if cnt and table.first_code[ln] <= value < table.first_code[ln] + cnt:
                break
            if ln > table.max_len:
                raise ValueError("invalid huffman stream")
        sidx = int(table.base_index[ln]) + value - int(table.first_code[ln])
        out[i] = table.sorted_symbols[sidx]
        off += ln
    return out


# ----------------------------------------------------------------------
# Payload assembly
# ----------------------------------------------------------------------


def _pack_payload(
    table_bytes: Optional[bytes], chunk_payloads: List[bytes]
) -> bytes:
    parts = []
    if table_bytes is None:
        parts.append(b"\x01")
    else:
        parts.append(b"\x00")
        assert len(table_bytes) == 256
        parts.append(table_bytes)
    parts.append(struct.pack("<H", len(chunk_payloads)))
    parts.append(
        struct.pack(f"<{len(chunk_payloads)}H", *[len(c) for c in chunk_payloads])
    )
    parts.extend(chunk_payloads)
    return b"".join(parts)


def _unpack_payload(payload: bytes) -> Tuple[Optional[bytes], List[bytes]]:
    # All parse failures must surface as ValueError (the fuzz contract:
    # corruption is detected cleanly) — a bit-flipped chunk count could
    # otherwise make struct.unpack_from read past the buffer and raise
    # struct.error (ADVICE r3).
    if not payload:
        raise ValueError("empty huffman payload")
    mode = payload[0]
    off = 1
    table_bytes = None
    if mode == 0:
        table_bytes = payload[1:257]
        if len(table_bytes) != 256:
            raise ValueError("truncated huffman payload (table)")
        off = 257
    elif mode != 1:
        raise ValueError(f"bad huffman table mode {mode}")
    if off + 2 > len(payload):
        raise ValueError("truncated huffman payload (chunk count)")
    (nc,) = struct.unpack_from("<H", payload, off)
    off += 2
    if off + 2 * nc > len(payload):
        raise ValueError("truncated huffman payload (chunk lengths)")
    lens = struct.unpack_from(f"<{nc}H", payload, off)
    off += 2 * nc
    chunks = []
    for ln in lens:
        chunks.append(payload[off : off + ln])
        if len(chunks[-1]) != ln:
            raise ValueError("truncated huffman payload")
        off += ln
    return table_bytes, chunks


# ----------------------------------------------------------------------
# Codec
# ----------------------------------------------------------------------


class HuffmanCodec(Codec):
    name = "huffman"

    def _chunk_counts(self, raw_len: int) -> List[int]:
        C = self.config.chunk_syms
        nc = max(1, -(-raw_len // C))
        return [max(0, min(C, raw_len - c * C)) for c in range(nc)]

    # -------------------------- encode --------------------------------

    def encode_blocks(self, blocks: np.ndarray, lengths: np.ndarray) -> EncodeResult:
        B = blocks.shape[0]
        if B == 0:
            return EncodeResult(payloads=[], shared_table=None)
        arity = self.config.arity
        lengths = np.asarray(lengths, np.int64)

        from data_compression_tpu.huffman import batched as hb

        # Histograms on the device; the device array is kept and reused
        # by the encode so the stream is uploaded exactly once.
        dev_blocks = None
        if self.config.use_device:
            import jax
            import jax.numpy as jnp

            from data_compression_tpu.ops.histogram import block_histograms
            from data_compression_tpu.utils.jit_cache import (
                enable_persistent_cache,
            )

            enable_persistent_cache()
            dev_blocks = jax.device_put(blocks)
            hists = np.asarray(
                block_histograms(dev_blocks, jnp.asarray(lengths, jnp.int32))
            ).astype(np.int64)
        else:
            hists = np.stack(
                [
                    np.bincount(blocks[i, : int(lengths[i])], minlength=256)
                    for i in range(B)
                ]
            ).astype(np.int64)

        shared_table_bytes = None
        if self.config.shared_table:
            lengths_tab = capped_lengths(hists.sum(axis=0), arity)
            tb = hb.codes_batch(
                np.tile(np.asarray(lengths_tab, np.int32), (B, 1)), arity
            )
            shared_table_bytes = np.asarray(lengths_tab, np.uint8).tobytes()
        else:
            tb = hb.codes_batch(hb.capped_lengths_batch(hists, arity), arity)

        # Generic arities (the reference's 9/10-ary experiments,
        # n_ary_huffman.c:1161-1208) have no bit-field wire packing, so
        # they ride the digit-generic host path regardless of
        # use_device; 2/3/16 get the device/native fast paths.
        if self.config.use_device and arity in FAST_ARITIES:
            payloads = self._encode_device(dev_blocks, lengths, tb, hists)
            return EncodeResult(payloads=payloads, shared_table=shared_table_bytes)
        chunk_payloads = self._encode_host(blocks, lengths, tb)

        shared = self.config.shared_table
        table_rows = None if shared else tb.table_bytes()
        payloads = []
        for i in range(B):
            row = None if shared else table_rows[i].tobytes()
            payloads.append(_pack_payload(row, chunk_payloads[i]))
        return EncodeResult(payloads=payloads, shared_table=shared_table_bytes)

    def _assemble_payloads(
        self,
        flat: np.ndarray,  # compacted wire bytes, chunk-concatenation order
        nb: np.ndarray,  # [B, ncb] per-chunk wire bytes
        raw_lens: np.ndarray,
        tb,
    ) -> List[bytes]:
        """Vectorized _pack_payload over all blocks: byte-identical
        frames, no per-chunk Python objects."""
        B, ncb = nb.shape
        C = self.config.chunk_syms
        n_real = np.maximum(1, -(-raw_lens // C)).astype(np.int64)
        block_data = nb.sum(axis=1)
        block_start = np.zeros(B + 1, np.int64)
        np.cumsum(block_data, out=block_start[1:])
        shared = self.config.shared_table
        table_rows = None if shared else tb.table_bytes()
        lens16 = nb.astype("<u2")
        mode = b"\x01" if shared else b"\x00"
        payloads = []
        for i in range(B):
            nr = int(n_real[i])
            parts = [mode]
            if table_rows is not None:
                parts.append(table_rows[i].tobytes())
            parts.append(struct.pack("<H", nr))
            parts.append(lens16[i, :nr].tobytes())
            parts.append(
                flat[block_start[i] : block_start[i] + block_data[i]].tobytes()
            )
            payloads.append(b"".join(parts))
        return payloads

    def _encode_host(self, blocks, lengths, tb) -> List[List[bytes]]:
        from data_compression_tpu import native
        from data_compression_tpu.huffman import batched as hb

        use_native = (
            native.load() is not None and self.config.arity in FAST_ARITIES
        )
        pt = bt = None
        if use_native:
            pt, bt = hb.packed_rows(tb)
        out = []
        C = self.config.chunk_syms
        for i in range(blocks.shape[0]):
            raw = blocks[i, : int(lengths[i])]
            table_i = None if use_native else tb.table(i)
            chunks = []
            for c, cnt in enumerate(self._chunk_counts(int(lengths[i]))):
                seg = raw[c * C : c * C + cnt]
                if use_native:
                    chunks.append(
                        native.huffman_encode_chunk(
                            seg, pt[i], bt[i], self.config.arity
                        )
                    )
                else:
                    chunks.append(encode_chunk_np(seg, table_i))
            out.append(chunks)
        return out

    def _encode_device(self, dev_blocks, lengths, tb, hists) -> List[bytes]:
        """Merge-tree encode + payload compaction in one jit; the host
        downloads only the compressed bytes (capacity bounded from the
        histograms) and assembles frames from one contiguous buffer."""
        import jax.numpy as jnp

        from data_compression_tpu.huffman import batched as hb
        from data_compression_tpu.ops.compaction import round_cap
        from data_compression_tpu.ops.encode_fast import encode_blocks_compact

        arity = self.config.arity
        B, S = dev_blocks.shape
        C = self.config.chunk_syms
        D = ARITY_DIGITS_PER_BYTE[arity]
        # exact capacity bound from the histograms: per-block digit
        # totals are sum(freq * len) (the reference's
        # find_compressed_data_size, n_ary_huffman.c:2466-2506); chunk
        # byte-rounding adds < 1 byte per chunk
        block_digits = (hists * tb.lengths.astype(np.int64)).sum(axis=1)
        bound = int((-(-block_digits // D)).sum()) + B * (S // C)
        pt, bt = hb.packed_rows(tb)
        flat_d, nb_d = encode_blocks_compact(
            dev_blocks,
            jnp.asarray(lengths, jnp.int32),
            jnp.asarray(pt),
            jnp.asarray(bt),
            arity=arity,
            chunk_syms=C,
            out_cap=round_cap(bound),
        )
        nb = np.asarray(nb_d).astype(np.int64)
        flat = np.asarray(flat_d[: int(nb.sum())])
        return self._assemble_payloads(
            flat, nb, np.asarray(lengths, np.int64), tb
        )

    # -------------------------- decode --------------------------------

    def decode_blocks(
        self,
        payloads: List[bytes],
        raw_lens: List[int],
        shared_table: Optional[bytes] = None,
    ) -> List[bytes]:
        if not payloads:
            return []
        arity = self.config.arity
        if self.config.use_device and arity in FAST_ARITIES:
            return self._decode_device_vec(payloads, raw_lens, shared_table)
        parsed = [_unpack_payload(p) for p in payloads]
        tables = []
        for (tb, _chunks), _ in zip(parsed, raw_lens):
            if tb is None:
                if shared_table is None:
                    raise ValueError("stream requires shared table but frame has none")
                tables.append(CanonicalTable.from_bytes(shared_table, arity))
            else:
                tables.append(CanonicalTable.from_bytes(tb, arity))
        return self._decode_host(parsed, raw_lens, tables)

    # ---------------- vectorized device decode -----------------------

    def _parse_payloads_vec(self, payloads, raw_lens, shared_table):
        """Vectorized payload parse: per-block numpy views, no
        per-chunk Python objects.  Returns (rows [B,256] u8 length
        tables, nb [B, ncb] int64 chunk byte counts, flat u8 wire
        bytes).  All corruption surfaces as ValueError (fuzz
        contract)."""
        B = len(payloads)
        C = self.config.chunk_syms
        ncb = self.config.block_size // C
        rows = np.empty((B, 256), np.uint8)
        shared_row = (
            np.frombuffer(shared_table, np.uint8, 256)
            if shared_table is not None and len(shared_table) >= 256
            else None
        )
        nb = np.zeros((B, ncb), np.int64)
        datas = []
        for i, p in enumerate(payloads):
            if not p:
                raise ValueError("empty huffman payload")
            mode = p[0]
            off = 1
            if mode == 0:
                if len(p) < 257:
                    raise ValueError("truncated huffman payload (table)")
                rows[i] = np.frombuffer(p, np.uint8, 256, 1)
                off = 257
            elif mode == 1:
                if shared_row is None:
                    raise ValueError(
                        "stream requires shared table but frame has none"
                    )
                rows[i] = shared_row
            else:
                raise ValueError(f"bad huffman table mode {mode}")
            if off + 2 > len(p):
                raise ValueError("truncated huffman payload (chunk count)")
            nc = p[off] | (p[off + 1] << 8)
            off += 2
            if off + 2 * nc > len(p):
                raise ValueError("truncated huffman payload (chunk lengths)")
            if nc > ncb:
                raise ValueError("huffman chunk count mismatch")
            counts = self._chunk_counts(int(raw_lens[i]))
            if nc != len(counts):
                raise ValueError("huffman chunk count mismatch")
            lens = np.frombuffer(p, "<u2", nc, off)
            off += 2 * nc
            total = int(lens.sum())
            if off + total > len(p):
                raise ValueError("truncated huffman payload")
            nb[i, :nc] = lens
            datas.append(np.frombuffer(p, np.uint8, total, off))
        flat = (
            np.concatenate(datas) if datas else np.zeros(0, np.uint8)
        )
        return rows, nb, flat

    def _decode_device_vec(self, payloads, raw_lens, shared_table):
        import jax
        import jax.numpy as jnp

        from data_compression_tpu.huffman import batched as hb
        from data_compression_tpu.ops.compaction import round_cap
        from data_compression_tpu.ops.decode_kernel import decode_chunks
        from data_compression_tpu.ops.huffman_coding import max_chunk_bytes
        from data_compression_tpu.utils.jit_cache import enable_persistent_cache

        enable_persistent_cache()
        arity = self.config.arity
        C = self.config.chunk_syms
        rows, nb, flat = self._parse_payloads_vec(
            payloads, raw_lens, shared_table
        )
        if int(nb.max(initial=0)) > max_chunk_bytes(C, arity):
            raise ValueError("huffman chunk payload too large")
        tb = hb.tables_from_bytes(rows, arity)
        B, ncb = nb.shape

        raw = np.asarray(raw_lens, np.int64)
        n_real = np.maximum(1, -(-raw // C))
        keep = np.arange(ncb)[None, :] < n_real[:, None]  # [B, ncb]
        counts = np.clip(
            raw[:, None] - np.arange(ncb, dtype=np.int64)[None, :] * C, 0, C
        )[keep]
        nb_keep = nb[keep]
        starts = np.zeros(nb_keep.size, np.int64)
        np.cumsum(nb_keep[:-1], out=starts[1:])
        tbl_of = np.repeat(np.arange(B, dtype=np.int32), n_real)
        # the compressed size is bucketed so frames of one stream share
        # a compiled decode
        flat_p = np.zeros(round_cap(flat.size), np.uint8)
        flat_p[: flat.size] = flat
        dr = hb.decode_rows(tb, ARITY_MAX_LEN[arity])
        syms = decode_chunks(
            jax.device_put(flat_p),
            jnp.asarray(starts, jnp.int32),
            jnp.asarray(counts, jnp.int32),
            jnp.asarray(tbl_of),
            jnp.asarray(dr["limit_scaled"].astype(np.int32)),
            jnp.asarray(dr["base_minus_first"].astype(np.int32)),
            jnp.asarray(dr["symbols"]),
            arity=arity,
            chunk_syms=C,
        )
        syms = np.asarray(syms)

        out = []
        start = 0
        for b in range(B):
            nc = int(n_real[b])
            out.append(syms[start : start + nc].reshape(-1)[: int(raw[b])].tobytes())
            start += nc
        return out

    def _decode_host(self, parsed, raw_lens, tables) -> List[bytes]:
        from data_compression_tpu import native

        use_native = (
            native.load() is not None and self.config.arity in FAST_ARITIES
        )
        L = ARITY_MAX_LEN[self.config.arity]
        dec_cache = {}

        def _dec(t):
            if id(t) not in dec_cache:
                dec_cache[id(t)] = build_decode_tables(t, pad_to=L)
            return dec_cache[id(t)]

        out = []
        for (tb, chunks), raw_len, table in zip(parsed, raw_lens, tables):
            counts = self._chunk_counts(raw_len)
            if len(chunks) != len(counts):
                raise ValueError("huffman chunk count mismatch")
            if use_native:
                parts = [
                    native.huffman_decode_chunk(
                        ch, cnt, _dec(table), self.config.arity, L
                    )
                    for ch, cnt in zip(chunks, counts)
                ]
            else:
                parts = [
                    decode_chunk_np(ch, cnt, table) for ch, cnt in zip(chunks, counts)
                ]
            out.append(np.concatenate(parts)[:raw_len].tobytes() if parts else b"")
        return out
