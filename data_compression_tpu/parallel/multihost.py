"""Multi-host (multi-process) pipeline.

The reference is a single-threaded filter; nothing distributed exists
there (SURVEY.md §2.5).  This module is the framework's multi-host
runtime per BASELINE.json's north star: shard a stream across hosts
over the network, build tables with a globally-reduced histogram (the
sum over the sharded block axis compiles to an all-reduce across
devices and hosts), and gather compressed blocks in order with exact
framing offsets.

Execution model (one process per host, jax.distributed):

  1. ``initialize()`` — jax.distributed.initialize(); afterwards
     jax.devices() spans every host and process_index() identifies the
     host.
  2. Each host owns the contiguous row range its devices hold
     (``jax.make_array_from_process_local_data`` assembles the global
     [B, S] array over the mesh without any host ever materializing
     the full input).
  3. The sharded encode step runs exactly as in pipeline.py — in
     shared-table mode the histogram all-reduce crosses hosts inside
     the jitted step.
  4. Per-block compressed lengths and payloads return replicated
     (XLA's allgather across hosts); every host computes identical exact
     offsets (prefix sum) and assembles the identical frame — host 0
     is only special for file writing.

Decompression is the mirror image: every host parses the same frame,
contributes its contiguous share of the chunk-sharded payload array,
and the decode step returns the symbols replicated so each host can
verify CRCs and reassemble the stream.

This module is for several hosts only: one process per host, each
driving all of that host's devices.  On one machine, one process drives
every card (parallel/pipeline.py); never start a second process on a
card that another JAX process holds.

Single-machine testing: run N processes with
``JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=K``
and jax.distributed's local coordinator — exercised by
tests/test_multihost.py via subprocesses.
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """jax.distributed.initialize wrapper (env-driven when args omitted)."""
    kwargs = {}
    if coordinator_address is not None:
        kwargs = dict(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    jax.distributed.initialize(**kwargs)


def process_local_block_ids(num_blocks: int) -> np.ndarray:
    """Strided ownership: host p owns blocks p, p+P, p+2P, ..."""
    p = jax.process_index()
    P_ = jax.process_count()
    return np.arange(p, num_blocks, P_)


def _mesh_1d():
    ndev = len(jax.devices())
    return jax.sharding.Mesh(
        np.asarray(jax.devices()).reshape(ndev, 1), ("data", "chunk")
    )


def compress_multihost_bytes(data: bytes, config) -> bytes:
    """Compress cooperatively across all processes; every host calls
    this with the SAME data (or reads the same file) and receives the
    identical framed stream.

    Shared-table mode (``config.shared_table``): one canonical table is
    built from the global histogram — the per-block histograms are
    summed inside the jitted step, which XLA lowers to an all-reduce
    across the block-sharded axis (within a host and across
    hosts), exactly the broadcast-table design of SURVEY.md §2.5.
    """
    from data_compression_tpu import framing
    from data_compression_tpu.huffman.canonical import lengths_to_codes
    from data_compression_tpu.models.huffman import _pack_payload, capped_lengths
    from data_compression_tpu.ops.encode_fast import pack_encode_table
    from data_compression_tpu.utils.crc import crc32

    assert config.codec == "huffman"
    S = config.block_size
    C = config.chunk_syms
    ncb = S // C
    arity = config.arity

    blocks, lengths = framing.split_blocks(data, S)
    B_real = blocks.shape[0]
    nproc = jax.process_count()
    ndev = len(jax.devices())
    Bp = max(-(-max(B_real, 1) // ndev) * ndev, ndev)
    pb = np.zeros((Bp, S), np.uint8)
    pb[:B_real] = blocks
    pl_ = np.zeros(Bp, np.int32)
    pl_[:B_real] = lengths

    mesh = _mesh_1d()
    dp = NamedSharding(mesh, P("data", None))
    rep = NamedSharding(mesh, P())

    # contiguous ownership: host p's devices hold rows [p*Bp/nproc, ...)
    per = Bp // nproc
    p = jax.process_index()
    local_rows = pb[p * per : (p + 1) * per]
    blocks_g = jax.make_array_from_process_local_data(dp, local_rows, (Bp, S))
    lengths_g = jax.make_array_from_process_local_data(rep, pl_, (Bp,))

    # histogram step -> host tables -> encode step.  The global sum is
    # computed in-jit so shared-table mode pays ONE cross-host
    # all-reduce of a [256] vector, not a gather of [B, 256].
    def hist_fn(blk, lens):
        from data_compression_tpu.ops.histogram import block_histograms

        h = block_histograms(blk, lens)
        return h, h.sum(axis=0)

    hist_step = jax.jit(hist_fn, in_shardings=(dp, rep), out_shardings=(rep, rep))
    hists, ghist = hist_step(blocks_g, lengths_g)

    shared_bytes = None
    if config.shared_table:
        table = lengths_to_codes(
            capped_lengths(np.asarray(ghist, np.int64), arity), arity
        )
        tables = [table] * Bp
        shared_bytes = table.to_bytes()
        pt0, bt0 = pack_encode_table(table)
        pt = [pt0] * Bp
        bt = [bt0] * Bp
    else:
        hists = np.asarray(hists).astype(np.int64)
        tables = [
            lengths_to_codes(capped_lengths(hists[i], arity), arity)
            for i in range(Bp)
        ]
        pt, bt = zip(*[pack_encode_table(t) for t in tables])

    def enc_fn(blk, lens, ptab, btab):
        from data_compression_tpu.ops.encode_fast import encode_chunks_fast

        Bx, Sx = blk.shape
        syms = blk.reshape(Bx * ncb, C)
        counts = jnp.clip(
            lens[:, None] - jnp.arange(ncb, dtype=lens.dtype)[None, :] * C, 0, C
        ).reshape(-1)
        tbl = jnp.broadcast_to(
            jnp.arange(Bx, dtype=jnp.int32)[:, None], (Bx, ncb)
        ).reshape(-1)
        pk, nb, _ = encode_chunks_fast(
            syms, counts, ptab, btab, tbl, arity=arity, chunk_syms=C
        )
        return pk, nb

    enc_step = jax.jit(
        enc_fn, in_shardings=(dp, rep, rep, rep), out_shardings=(rep, rep)
    )
    packed, nbytes = enc_step(
        blocks_g,
        lengths_g,
        jax.make_array_from_process_local_data(rep, np.stack(pt), (Bp, 256)),
        jax.make_array_from_process_local_data(rep, np.stack(bt), (Bp, 256)),
    )
    packed = np.asarray(packed)  # replicated: full result on every host
    nbytes = np.asarray(nbytes)

    payloads, raw_lens, crcs, flags = [], [], [], []
    for i in range(B_real):
        raw_len = int(pl_[i])
        nc_real = max(1, -(-raw_len // C))
        chunks = [
            packed[i * ncb + c, : int(nbytes[i * ncb + c])].tobytes()
            for c in range(nc_real)
        ]
        tb = None if config.shared_table else tables[i].to_bytes()
        payload = _pack_payload(tb, chunks)
        raw = pb[i, :raw_len].tobytes()
        crcs.append(crc32(raw))
        raw_lens.append(raw_len)
        if len(payload) >= raw_len:
            payloads.append(raw)
            flags.append(framing.BLOCK_LITERAL)
        else:
            payloads.append(payload)
            flags.append(0)
    return framing.pack_frame(
        config.codec_id, arity, S, len(data), payloads, raw_lens, crcs, flags,
        shared_table=shared_bytes,
        chunk_log2=C.bit_length() - 1,
    )


def decompress_multihost_bytes(data: bytes, config=None) -> bytes:
    """Decompress a framed stream cooperatively across all processes.

    Every host parses the same frame (the block table is tiny), owns a
    contiguous share of the chunk-sharded payload array, and receives
    the decoded symbols replicated — so every host returns the full
    stream and verifies every block CRC.  Mirrors the reference's
    parallel-decode design note (small_compression.c:924-927) at
    multi-host scale.
    """
    from data_compression_tpu import framing
    from data_compression_tpu.config import ARITY_MAX_LEN
    from data_compression_tpu.huffman.canonical import (
        build_decode_tables,
        lengths_to_codes,
    )
    from data_compression_tpu.models.huffman import _unpack_payload
    from data_compression_tpu.ops.huffman_coding import max_chunk_bytes
    from data_compression_tpu.utils.crc import crc32

    frame = framing.unpack_frame(data)
    arity = frame.arity
    C = frame.chunk_syms or (config.chunk_syms if config else 4096)
    mb = max_chunk_bytes(C, arity)

    entries = frame.entries
    out: List[Optional[bytes]] = [None] * len(entries)
    flat_chunks: List[bytes] = []
    flat_counts: List[int] = []
    flat_tbl: List[int] = []
    spans = []
    tables = []
    tb_cache = {}
    for i, e in enumerate(entries):
        if e.is_literal:
            out[i] = frame.payloads[i]
            continue
        tb, chunks = _unpack_payload(frame.payloads[i])
        if tb is None:
            tb = frame.shared_table
            if tb is None:
                raise ValueError("stream requires shared table")
        if tb not in tb_cache:
            tb_cache[tb] = len(tables)
            tables.append(
                lengths_to_codes(np.frombuffer(tb, np.uint8).astype(np.int32), arity)
            )
        ti = tb_cache[tb]
        counts = [
            max(0, min(C, e.raw_len - c * C))
            for c in range(max(1, -(-e.raw_len // C)))
        ]
        if len(chunks) != len(counts):
            raise ValueError("chunk count mismatch")
        spans.append((i, len(flat_chunks), len(chunks), e.raw_len))
        flat_chunks.extend(chunks)
        flat_counts.extend(counts)
        flat_tbl.extend([ti] * len(chunks))

    if flat_chunks:
        mesh = _mesh_1d()
        cs = NamedSharding(mesh, P("data", None))
        rep = NamedSharding(mesh, P())
        ndev = len(jax.devices())
        nproc = jax.process_count()
        N = len(flat_chunks)
        Np = -(-N // ndev) * ndev
        payload_arr = np.zeros((Np, mb), np.uint8)
        for k, ch in enumerate(flat_chunks):
            payload_arr[k, : len(ch)] = np.frombuffer(ch, np.uint8)
        counts_arr = np.zeros(Np, np.int32)
        counts_arr[:N] = flat_counts
        tbl_arr = np.zeros(Np, np.int32)
        tbl_arr[:N] = flat_tbl

        dec = [build_decode_tables(t, pad_to=ARITY_MAX_LEN[arity]) for t in tables]
        limit = np.stack([d["limit_scaled"] for d in dec]).astype(np.int32)
        bmf = np.stack([d["base_minus_first"] for d in dec]).astype(np.int32)
        symtab = np.stack([d["symbols"] for d in dec]).astype(np.int32)

        per = Np // nproc
        p = jax.process_index()
        payload_g = jax.make_array_from_process_local_data(
            cs, payload_arr[p * per : (p + 1) * per], (Np, mb)
        )
        ds = NamedSharding(mesh, P("data"))

        from jax import shard_map

        from data_compression_tpu.ops.decode_kernel import decode_chunks

        def local(payload, counts, tb, lim, bm, st):
            # each device decodes its rows of the padded payload array
            starts = jnp.arange(payload.shape[0], dtype=jnp.int32) * mb
            return decode_chunks(
                payload.reshape(-1), starts, counts, tb, lim, bm, st,
                arity=arity, chunk_syms=C,
            )

        dec_step = jax.jit(
            shard_map(
                local,
                mesh=mesh,
                in_specs=(P("data"), P("data"), P("data"), P(), P(), P()),
                out_specs=P("data"),
                check_vma=False,
            ),
            out_shardings=rep,  # replicated: full decode on every host
        )
        syms = np.asarray(
            dec_step(
                payload_g,
                jax.make_array_from_process_local_data(
                    ds, counts_arr[p * per : (p + 1) * per], (Np,)
                ),
                jax.make_array_from_process_local_data(
                    ds, tbl_arr[p * per : (p + 1) * per], (Np,)
                ),
                jax.make_array_from_process_local_data(rep, limit, limit.shape),
                jax.make_array_from_process_local_data(rep, bmf, bmf.shape),
                jax.make_array_from_process_local_data(rep, symtab, symtab.shape),
            )
        )
        for i, start, nc, raw_len in spans:
            out[i] = syms[start : start + nc].reshape(-1)[:raw_len].tobytes()

    for i, e in enumerate(entries):
        blk = out[i]
        assert blk is not None
        if len(blk) != e.raw_len or crc32(blk) != e.crc:
            raise ValueError(f"block {i}: integrity check failed")
    result = b"".join(out)
    if len(result) != frame.total_len:
        raise ValueError("total length mismatch")
    return result


def compress_multihost(local_data_path: str, out_path: str, config) -> dict:
    """File driver: every host calls with the same args; host 0 writes."""
    with open(local_data_path, "rb") as f:
        data = f.read()
    out = compress_multihost_bytes(data, config)
    if jax.process_index() == 0:
        with open(out_path, "wb") as f:
            f.write(out)
        return {
            "raw_bytes": len(data),
            "compressed_bytes": len(out),
            "hosts": jax.process_count(),
        }
    return {}


def decompress_multihost(in_path: str, out_path: str, config=None) -> dict:
    """File driver for multihost decompression; host 0 writes."""
    with open(in_path, "rb") as f:
        data = f.read()
    out = decompress_multihost_bytes(data, config)
    if jax.process_index() == 0:
        with open(out_path, "wb") as f:
            f.write(out)
    return {"compressed_bytes": len(data), "raw_bytes": len(out)}


# ----------------------------------------------------------------------
# Scaling-efficiency harness
# ----------------------------------------------------------------------


def measure_encode_throughput(config, nbytes: int, iters: int = 4) -> dict:
    """Steady-state sharded-encode throughput on the current topology.

    Runs the jitted device encode step (histogram + chunked encode) over
    a synthetic corpus ``iters`` times and reports bytes/s for the best
    run.  Called under 1 and N processes, the ratio gives the scaling
    efficiency BASELINE.json targets (≥90% at 2+ hosts):

        eff = (bytes_per_s_N / N) / bytes_per_s_1

    On a single machine with virtual CPU devices the number is a
    simulation (the processes share physical cores); on a real pod it
    measures ICI/DCN overhead honestly.
    """
    from data_compression_tpu.huffman.canonical import lengths_to_codes
    from data_compression_tpu.models.huffman import capped_lengths
    from data_compression_tpu.ops.encode_fast import pack_encode_table
    from data_compression_tpu.utils.corpora import synthetic_enwik
    from data_compression_tpu import framing

    S = config.block_size
    C = config.chunk_syms
    ncb = S // C
    arity = config.arity
    data = synthetic_enwik(nbytes, seed=7)
    blocks, lengths = framing.split_blocks(data, S)
    ndev = len(jax.devices())
    nproc = jax.process_count()
    B = -(-blocks.shape[0] // ndev) * ndev
    pb = np.zeros((B, S), np.uint8)
    pb[: blocks.shape[0]] = blocks
    pl_ = np.zeros(B, np.int32)
    pl_[: blocks.shape[0]] = lengths

    mesh = _mesh_1d()
    dp = NamedSharding(mesh, P("data", None))
    rep = NamedSharding(mesh, P())
    per = B // nproc
    p = jax.process_index()
    blocks_g = jax.make_array_from_process_local_data(
        dp, pb[p * per : (p + 1) * per], (B, S)
    )
    lengths_g = jax.make_array_from_process_local_data(rep, pl_, (B,))

    # one table for the whole run (steady-state kernel cost, no host work)
    hist = np.bincount(pb.reshape(-1), minlength=256).astype(np.int64)
    table = lengths_to_codes(capped_lengths(hist, arity), arity)
    pt, bt = pack_encode_table(table)
    ptab = jax.make_array_from_process_local_data(
        rep, np.broadcast_to(pt, (B, 256)).copy(), (B, 256)
    )
    btab = jax.make_array_from_process_local_data(
        rep, np.broadcast_to(bt, (B, 256)).copy(), (B, 256)
    )

    def enc_fn(blk, lens, ptab, btab):
        from data_compression_tpu.ops.encode_fast import encode_chunks_fast

        Bx = blk.shape[0]
        syms = blk.reshape(Bx * ncb, C)
        counts = jnp.clip(
            lens[:, None] - jnp.arange(ncb, dtype=lens.dtype)[None, :] * C, 0, C
        ).reshape(-1)
        tbl = jnp.broadcast_to(
            jnp.arange(Bx, dtype=jnp.int32)[:, None], (Bx, ncb)
        ).reshape(-1)
        pk, nb, _ = encode_chunks_fast(
            syms, counts, ptab, btab, tbl, arity=arity, chunk_syms=C
        )
        return nb

    enc_step = jax.jit(
        enc_fn, in_shardings=(dp, rep, rep, rep), out_shardings=rep
    )
    # compute-only variant: output stays data-sharded, so the timing
    # difference vs enc_step isolates the final all-gather (the
    # collective share of the step)
    dp1 = NamedSharding(mesh, P("data"))  # rank-1: per-chunk byte counts
    enc_local = jax.jit(
        enc_fn, in_shardings=(dp, rep, rep, rep), out_shardings=dp1
    )
    jax.block_until_ready(enc_step(blocks_g, lengths_g, ptab, btab))  # compile
    jax.block_until_ready(enc_local(blocks_g, lengths_g, ptab, btab))
    best = float("inf")
    best_local = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(enc_step(blocks_g, lengths_g, ptab, btab))
        best = min(best, time.perf_counter() - t0)
        t0 = time.perf_counter()
        jax.block_until_ready(enc_local(blocks_g, lengths_g, ptab, btab))
        best_local = min(best_local, time.perf_counter() - t0)
    return {
        "bytes": nbytes,
        "best_s": best,
        "bytes_per_s": nbytes / best,
        "compute_s": best_local,
        "collective_s": max(0.0, best - best_local),
        "processes": nproc,
        "devices": ndev,
    }
