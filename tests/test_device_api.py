"""Device-resident pipeline (device_api.py) on the CPU's XLA route:
wire parity against the host encoder and the round trip, at n = 2, 3,
16."""

import numpy as np
import pytest

import jax.numpy as jnp

from data_compression_tpu import device_api
from data_compression_tpu.config import CodecConfig
from data_compression_tpu.huffman import batched as hb
from data_compression_tpu.models.huffman import HuffmanCodec
from tests.conftest import ascii_text

S = 128 * 128  # chunk_syms=128: 128 chunks per block


def _blocks(rng):
    data = ascii_text(rng, S + S // 2)
    blocks = np.zeros((2, S), np.uint8)
    blocks.reshape(-1)[: len(data)] = np.frombuffer(data, np.uint8)
    return blocks, np.asarray([S, S // 2], np.int64)


def _config(arity, **kw):
    return CodecConfig(codec="huffman", arity=arity, block_size=S,
                       chunk_syms=128, **kw)


@pytest.mark.parametrize("arity", [2, 3, 16])
def test_compress_device_wire_parity(rng, arity):
    """Device compress emits the same wire bytes as the host encoder
    (tables built on device, bit-identical)."""
    blocks, raw_lens = _blocks(rng)
    dc = device_api.compress_blocks_device(
        jnp.asarray(blocks), raw_lens, _config(arity)
    )
    flat = np.asarray(dc.flat)[: dc.total_bytes()]
    hists = np.stack(
        [np.bincount(blocks[i, : raw_lens[i]], minlength=256) for i in range(2)]
    ).astype(np.int64)
    tb = hb.codes_batch(hb.capped_lengths_batch(hists, arity), arity)
    assert np.array_equal(np.asarray(dc.table_lengths), tb.table_bytes())
    codec = HuffmanCodec(_config(arity, use_device=False))
    chunk_payloads = codec._encode_host(blocks, raw_lens, tb)
    want = b"".join(b"".join(chunks) for chunks in chunk_payloads)
    assert flat.tobytes() == want


@pytest.mark.parametrize("arity", [2, 3, 16])
def test_decode_device_roundtrip(rng, arity):
    """compress_blocks_device -> decompress_blocks_device, all tables
    derived on device; bytes past a block's raw length decode to 0."""
    blocks, raw_lens = _blocks(rng)
    dc = device_api.compress_blocks_device(
        jnp.asarray(blocks), raw_lens, _config(arity)
    )
    out = np.asarray(device_api.decompress_blocks_device(dc))
    assert np.array_equal(out, blocks)


def test_decode_device_kernel_interpret(rng):
    """The same round trip through the GPU kernel in the interpreter."""
    blocks, raw_lens = _blocks(rng)
    dc = device_api.compress_blocks_device(
        jnp.asarray(blocks), raw_lens, _config(3)
    )
    out = device_api.decompress_blocks_device(dc, interpret=True)
    assert np.array_equal(np.asarray(out), blocks)
