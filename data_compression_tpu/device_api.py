"""Device-resident compression: data already in device memory.

`api.compress` serves host-resident bytes.  This module serves a
producer whose data already lives on the device (checkpoint shards,
activation dumps, device-side logs): per-block histogram, on-device
Huffman tree build (ops/table_build.py), canonical code assignment and
encode tables run as one compiled dispatch; the merge-tree encode and
payload compaction (ops/encode_fast.encode_blocks_compact) as a second.
The only host sync between them is one small download: the per-block
capacity bound that sizes the compacted output exactly.

The inverse direction mirrors it: wire length tables -> on-device
canonical decode tables -> ops/decode_kernel.decode_chunks, one
dispatch, output left on the device.

Wire parity: payload bytes and tables are bit-identical to
`api.compress` (same table builder semantics, differential-tested in
tests/test_device_api.py).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np

from data_compression_tpu.config import (
    ARITY_DIGITS_PER_BYTE,
    ARITY_MAX_LEN,
    CodecConfig,
)


@functools.lru_cache(maxsize=None)
def _tables_fn(arity: int, chunk_syms: int):
    import jax
    import jax.numpy as jnp

    from data_compression_tpu.ops.histogram import block_histograms
    from data_compression_tpu.ops.table_build import (
        encode_tables_device,
        huffman_lengths_device,
    )

    D = ARITY_DIGITS_PER_BYTE[arity]

    @jax.jit
    def fn(blocks, raw_lens):
        hists = block_histograms(blocks, raw_lens)
        lengths = huffman_lengths_device(hists, arity)
        packed, bits = encode_tables_device(lengths, arity)
        # per-block capacity bound: sum(freq * len) digits, byte-rounded,
        # plus < 1 byte per chunk (summed on the host in int64)
        digits = (hists * lengths).sum(axis=1)
        bound = -(-digits // D) + blocks.shape[1] // chunk_syms
        return packed, bits, lengths.astype(jnp.uint8), bound

    return fn


@dataclasses.dataclass
class DeviceCompressed:
    """Device-resident compressed stream: everything needed to frame or
    decode, as device arrays."""

    flat: object  # uint8 wire bytes, all chunk payloads back to back
    nb: object  # [B, S/C] int32 — per-chunk wire byte counts
    table_lengths: object  # [B, 256] uint8 — per-block wire tables
    raw_lens: np.ndarray  # [B] host — valid bytes per block
    arity: int
    chunk_syms: int

    def total_bytes(self) -> int:
        return int(np.asarray(self.nb).sum())


def compress_blocks_device(
    blocks,  # [B, S] uint8 device array
    raw_lens: np.ndarray,
    config: Optional[CodecConfig] = None,
) -> DeviceCompressed:
    """Compress device-resident blocks: a tables dispatch, one small
    download (the capacity bound), an encode dispatch."""
    import jax.numpy as jnp

    from data_compression_tpu.ops.compaction import round_cap
    from data_compression_tpu.ops.encode_fast import encode_blocks_compact
    from data_compression_tpu.utils.jit_cache import enable_persistent_cache

    enable_persistent_cache()
    config = config or CodecConfig()
    arity = config.arity
    C = config.chunk_syms
    lens_dev = jnp.asarray(np.asarray(raw_lens, np.int32))
    packed, bits, rows, bound = _tables_fn(arity, C)(blocks, lens_dev)
    cap = round_cap(int(np.asarray(bound).astype(np.int64).sum()))
    flat, nb = encode_blocks_compact(
        blocks, lens_dev, packed, bits, arity=arity, chunk_syms=C,
        out_cap=cap,
    )
    return DeviceCompressed(
        flat=flat, nb=nb, table_lengths=rows,
        raw_lens=np.asarray(raw_lens, np.int64),
        arity=arity, chunk_syms=C,
    )


@functools.lru_cache(maxsize=None)
def _decode_fn(arity: int, chunk_syms: int, interpret: bool):
    import jax
    import jax.numpy as jnp

    from data_compression_tpu.ops.decode_kernel import decode_chunks
    from data_compression_tpu.ops.table_build import decode_tables_device

    C = chunk_syms

    @jax.jit
    def fn(flat, nb, table_rows, raw_lens):
        B, ncb = nb.shape
        lim, bmf, syms = decode_tables_device(
            table_rows.astype(jnp.int32), arity, ARITY_MAX_LEN[arity]
        )
        nbf = nb.reshape(-1).astype(jnp.int32)
        starts = jnp.cumsum(nbf) - nbf
        counts = jnp.clip(
            raw_lens[:, None] - jnp.arange(ncb, dtype=jnp.int32)[None, :] * C,
            0,
            C,
        ).reshape(-1)
        tbl = jnp.repeat(jnp.arange(B, dtype=jnp.int32), ncb)
        out = decode_chunks(
            flat, starts, counts, tbl, lim, bmf, syms,
            arity=arity, chunk_syms=C, interpret=interpret,
        )
        out = out.reshape(B, ncb * C)
        pos = jnp.arange(ncb * C, dtype=jnp.int32)[None, :]
        return jnp.where(pos < raw_lens[:, None], out, 0).astype(jnp.uint8)

    return fn


def decompress_blocks_device(dc: DeviceCompressed, interpret: bool = False):
    """Decode a DeviceCompressed back to [B, S] uint8 on the device
    (bytes past each block's raw length are zero)."""
    import jax.numpy as jnp

    from data_compression_tpu.utils.jit_cache import enable_persistent_cache

    enable_persistent_cache()
    return _decode_fn(dc.arity, dc.chunk_syms, interpret)(
        dc.flat, dc.nb, dc.table_lengths,
        jnp.asarray(np.asarray(dc.raw_lens, np.int32)),
    )
