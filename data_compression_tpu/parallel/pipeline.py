"""Sharded compress/decompress pipeline (one or several devices).

Execution schedule per stream:
  1. device: per-block histograms, blocks sharded over 'data'; the
     shared-table mode's global histogram is the all-reduce XLA
     inserts for the sum over the sharded block axis;
  2. host:   canonical tables from the histograms (native C code
     lengths, bit-identical to the single-device path), replicated
     to the mesh;
  3. device: under shard_map, every device encodes its contiguous range
     of chunks (ops/encode_fast merge tree) and compacts its payloads;
  4. host:   per-device compressed bytes concatenate in device order,
     which is chunk order, and frame exactly as api.compress does.

Decode shards the chunks the same way: each device gets its chunks'
payload bytes and runs ops/decode_kernel.decode_chunks (the GPU kernel
on GPUs, the XLA decode on the CPU).  The stream is byte-identical to
the single-device api.compress stream.
"""

from __future__ import annotations

from typing import List, Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from data_compression_tpu.config import ARITY_DIGITS_PER_BYTE, ARITY_MAX_LEN, CodecConfig
from data_compression_tpu.ops.huffman_coding import max_chunk_bytes

CHUNKS = ("data", "chunk")  # chunk axis is sharded over the whole mesh


def make_sharded_hist_step(mesh: Mesh):
    """jitted fn(blocks [B,S], lengths [B]) -> (hists [B,256],
    global_hist [256]); the global sum is the mesh all-reduce of the
    shared-table mode."""
    dp = NamedSharding(mesh, P("data", None))
    rep = NamedSharding(mesh, P())

    from data_compression_tpu.ops.histogram import block_histograms

    def step(blocks, lengths):
        hists = block_histograms(blocks, lengths)
        return hists, hists.sum(axis=0)

    return jax.jit(step, in_shardings=(dp, rep), out_shardings=(rep, rep))


def make_sharded_encode_step(mesh: Mesh, arity: int, chunk_syms: int,
                             cap_per_device: int):
    """jitted fn(syms [N, C], counts [N], tbl_of_chunk [N], packed_tab
    [T, 256], bits_tab [T, 256]) -> (flat [ndev * cap] uint8, nbytes
    [N]); device d's compacted payloads sit at flat[d * cap:]."""
    from jax import shard_map

    from data_compression_tpu.ops.compaction import compact_rows
    from data_compression_tpu.ops.encode_fast import encode_chunks_fast

    def local(syms, counts, tbl, packed_tab, bits_tab):
        packed, nbytes, _ = encode_chunks_fast(
            syms, counts, packed_tab, bits_tab, tbl, arity=arity,
            chunk_syms=chunk_syms,
        )
        return compact_rows(packed, nbytes, cap_per_device), nbytes

    return jax.jit(shard_map(
        local,
        mesh=mesh,
        in_specs=(P(CHUNKS), P(CHUNKS), P(CHUNKS), P(), P()),
        out_specs=(P(CHUNKS), P(CHUNKS)),
        check_vma=False,
    ))


def make_sharded_decode_step(mesh: Mesh, arity: int, chunk_syms: int):
    """jitted fn(flat [ndev, F] uint8, starts [N], counts [N],
    tbl_of_chunk [N], limit, bmf, symbols) -> [N, C] uint8; row d of
    ``flat`` holds device d's chunk payloads, ``starts`` are offsets
    into that row."""
    from jax import shard_map

    from data_compression_tpu.ops.decode_kernel import decode_chunks

    def local(flat, starts, counts, tbl, limit, bmf, symbols):
        return decode_chunks(
            flat[0], starts, counts, tbl, limit, bmf, symbols,
            arity=arity, chunk_syms=chunk_syms,
        )

    return jax.jit(shard_map(
        local,
        mesh=mesh,
        in_specs=(P(CHUNKS), P(CHUNKS), P(CHUNKS), P(CHUNKS), P(), P(), P()),
        out_specs=P(CHUNKS),
        check_vma=False,
    ))


# ----------------------------------------------------------------------
# Host orchestration
# ----------------------------------------------------------------------


def _pad_blocks(blocks: np.ndarray, lengths: np.ndarray, multiple: int):
    B = blocks.shape[0]
    Bp = -(-max(B, 1) // multiple) * multiple
    if Bp == B:
        return blocks, lengths, B
    pb = np.zeros((Bp, blocks.shape[1]), np.uint8)
    pb[:B] = blocks
    pl = np.zeros(Bp, lengths.dtype)
    pl[:B] = lengths
    return pb, pl, B


def compress_sharded(
    data: bytes,
    config: CodecConfig,
    mesh: Optional[Mesh] = None,
) -> bytes:
    """Multi-device framed compression (huffman codec); the stream is
    byte-identical to ``api.compress(data, config)``."""
    from data_compression_tpu import framing
    from data_compression_tpu.huffman import batched as hb
    from data_compression_tpu.models.huffman import HuffmanCodec
    from data_compression_tpu.ops.compaction import round_cap
    from data_compression_tpu.utils.crc import crc32_blocks
    from data_compression_tpu.utils.jit_cache import enable_persistent_cache

    assert config.codec == "huffman"
    enable_persistent_cache()
    if mesh is None:
        from data_compression_tpu.parallel.mesh import make_mesh

        mesh = make_mesh()
    arity = config.arity
    C = config.chunk_syms
    S = config.block_size
    ncb = S // C
    ndev = mesh.devices.size

    blocks, lengths = framing.split_blocks(data, S)
    B_real = blocks.shape[0]
    if B_real == 0:
        return framing.pack_frame(
            config.codec_id, arity, S, 0, [], [], [], [], None,
            chunk_log2=C.bit_length() - 1,
        )
    blocks, lengths, _ = _pad_blocks(blocks, lengths, ndev)
    B = blocks.shape[0]

    dp = NamedSharding(mesh, P("data", None))
    rep = NamedSharding(mesh, P())
    cs = NamedSharding(mesh, P(CHUNKS))
    blocks_d = jax.device_put(blocks, dp)
    hists, ghist = make_sharded_hist_step(mesh)(
        blocks_d, jax.device_put(lengths.astype(np.int32), rep)
    )
    hists = np.asarray(hists).astype(np.int64)

    if config.shared_table:
        row = hb.capped_lengths_batch(np.asarray(ghist, np.int64)[None], arity)
        tb = hb.codes_batch(np.tile(row, (B, 1)), arity)
        shared_bytes = row[0].astype(np.uint8).tobytes()
    else:
        tb = hb.codes_batch(hb.capped_lengths_batch(hists, arity), arity)
        shared_bytes = None
    pt, bt = hb.packed_rows(tb)

    # per-device capacity: the histogram bound of every block a
    # device's chunk range touches
    D = ARITY_DIGITS_PER_BYTE[arity]
    block_bound = -(-(hists * tb.lengths.astype(np.int64)).sum(axis=1) // D) + ncb
    per_dev = B * ncb // ndev
    first = np.arange(ndev) * per_dev // ncb
    last = ((np.arange(ndev) + 1) * per_dev - 1) // ncb
    csum = np.concatenate([[0], np.cumsum(block_bound)])
    cap = round_cap(int((csum[last + 1] - csum[first]).max()))

    counts = np.clip(
        lengths.astype(np.int64)[:, None] - np.arange(ncb)[None, :] * C, 0, C
    ).reshape(-1)
    step = make_sharded_encode_step(mesh, arity, C, cap)
    flat_d, nbytes_d = step(
        blocks_d.reshape(B * ncb, C),
        jax.device_put(counts.astype(np.int32), cs),
        jax.device_put(np.repeat(np.arange(B, dtype=np.int32), ncb), cs),
        jax.device_put(pt, rep),
        jax.device_put(bt, rep),
    )
    nb = np.asarray(nbytes_d).astype(np.int64)
    dev_tot = nb.reshape(ndev, per_dev).sum(axis=1)
    flat = np.concatenate(
        [np.asarray(flat_d[d * cap : d * cap + int(dev_tot[d])])
         for d in range(ndev)]
    )

    codec = HuffmanCodec(config)
    payloads = codec._assemble_payloads(
        flat, nb.reshape(B, ncb)[:B_real], lengths[:B_real].astype(np.int64),
        tb,
    )
    crcs = crc32_blocks(blocks[:B_real], lengths[:B_real])
    out_payloads, raw_lens, flags = [], [], []
    for i, payload in enumerate(payloads):
        raw_len = int(lengths[i])
        raw_lens.append(raw_len)
        if len(payload) >= raw_len:
            out_payloads.append(blocks[i, :raw_len].tobytes())
            flags.append(framing.BLOCK_LITERAL)
        else:
            out_payloads.append(payload)
            flags.append(0)

    return framing.pack_frame(
        config.codec_id,
        arity,
        S,
        len(data),
        out_payloads,
        raw_lens,
        [int(c) for c in crcs],
        flags,
        shared_table=shared_bytes,
        chunk_log2=C.bit_length() - 1,
    )


def decompress_sharded(
    data: bytes,
    config: Optional[CodecConfig] = None,
    mesh: Optional[Mesh] = None,
) -> bytes:
    """Multi-device framed decompression (huffman codec)."""
    from data_compression_tpu import framing
    from data_compression_tpu.huffman import batched as hb
    from data_compression_tpu.models.huffman import _unpack_payload
    from data_compression_tpu.utils.crc import crc32
    from data_compression_tpu.utils.jit_cache import enable_persistent_cache

    enable_persistent_cache()
    if mesh is None:
        from data_compression_tpu.parallel.mesh import make_mesh

        mesh = make_mesh()
    ndev = mesh.devices.size
    frame = framing.unpack_frame(data)
    arity = frame.arity
    C = frame.chunk_syms or (config.chunk_syms if config else 4096)
    mb = max_chunk_bytes(C, arity)

    # Collect huffman-coded blocks (literal blocks pass through).
    entries = frame.entries
    out: List[Optional[bytes]] = [None] * len(entries)
    chunks_all: List[bytes] = []
    counts: List[int] = []
    tbl: List[int] = []
    rows = []
    spans = []
    for i, e in enumerate(entries):
        if e.is_literal:
            out[i] = frame.payloads[i]
            continue
        tb, chunks = _unpack_payload(frame.payloads[i])
        if tb is None:
            tb = frame.shared_table
            if tb is None:
                raise ValueError("stream requires shared table")
        cnt = [
            max(0, min(C, e.raw_len - c * C))
            for c in range(max(1, -(-e.raw_len // C)))
        ]
        if len(chunks) != len(cnt):
            raise ValueError("chunk count mismatch")
        if any(len(ch) > mb for ch in chunks):
            raise ValueError("huffman chunk payload too large")
        spans.append((i, len(chunks_all), len(chunks), e.raw_len))
        tbl.extend([len(rows)] * len(chunks))
        rows.append(np.frombuffer(tb, np.uint8))
        chunks_all.extend(chunks)
        counts.extend(cnt)

    if chunks_all:
        N = len(chunks_all)
        per_dev = -(-N // ndev)
        Np = per_dev * ndev
        nb = np.zeros(Np, np.int64)
        nb[:N] = [len(ch) for ch in chunks_all]
        flat = np.frombuffer(b"".join(chunks_all), np.uint8)
        # device d's payload bytes in row d; starts relative to its row
        ends = np.cumsum(nb)
        starts = ends - nb
        dev_first = starts[:: per_dev]
        dev_len = ends[per_dev - 1 :: per_dev] - dev_first
        width = max(1, int(dev_len.max()))
        rows_flat = np.zeros((ndev, width), np.uint8)
        for d in range(ndev):
            seg = flat[dev_first[d] : dev_first[d] + dev_len[d]]
            rows_flat[d, : seg.size] = seg
        local_starts = starts - np.repeat(dev_first, per_dev)
        cnt_arr = np.zeros(Np, np.int32)
        cnt_arr[:N] = counts
        tbl_arr = np.zeros(Np, np.int32)
        tbl_arr[:N] = tbl

        tbb = hb.tables_from_bytes(np.stack(rows), arity)
        dr = hb.decode_rows(tbb, ARITY_MAX_LEN[arity])
        cs = NamedSharding(mesh, P(CHUNKS))
        rep = NamedSharding(mesh, P())
        step = make_sharded_decode_step(mesh, arity, C)
        syms = np.asarray(
            step(
                jax.device_put(rows_flat, cs),
                jax.device_put(local_starts.astype(np.int32), cs),
                jax.device_put(cnt_arr, cs),
                jax.device_put(tbl_arr, cs),
                jax.device_put(dr["limit_scaled"].astype(np.int32), rep),
                jax.device_put(dr["base_minus_first"].astype(np.int32), rep),
                jax.device_put(dr["symbols"].astype(np.int32), rep),
            )
        )
        for i, start, nc, raw_len in spans:
            out[i] = syms[start : start + nc].reshape(-1)[:raw_len].tobytes()

    for i, e in enumerate(entries):
        blk = out[i]
        assert blk is not None
        if len(blk) != e.raw_len or crc32(blk) != e.crc:
            raise ValueError(f"block {i}: integrity check failed")
    result = b"".join(out)  # ordered join
    if len(result) != frame.total_len:
        raise ValueError("total length mismatch")
    return result
