"""Tests that need the card: the decode kernel compiled for the GPU
against the plain XLA decode and the input, and the entry points on the
card against the host reference.  Run with
``python -m pytest tests -m gpu`` (chip_smoke.py runs them too)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import bench
from data_compression_tpu import api, device_api
from data_compression_tpu.config import ARITY_MAX_LEN, CodecConfig
from data_compression_tpu.huffman import batched as hb
from data_compression_tpu.ops import decode_kernel as dk

pytestmark = pytest.mark.gpu


def test_decode_route_is_the_kernel(gpu):
    assert dk.decode_route(jax.default_backend()) == "kernel"


@pytest.mark.parametrize("arity", [2, 3, 16])
def test_kernel_matches_decode_fast(gpu, arity):
    """512-symbol chunks, 128 per block, 256 blocks: kernel == XLA
    decode == input."""
    data = bench.make_corpus(256 * bench.S, seed=arity)
    (blocks, lens, pt, bt), tb, cap = bench._prep_huffman(data, arity)
    from data_compression_tpu.ops.encode_fast import encode_blocks_compact

    flat, nb = encode_blocks_compact(blocks, lens, pt, bt, arity=arity,
                                     chunk_syms=bench.C, out_cap=cap)
    nbf = nb.reshape(-1)
    N = nbf.shape[0]
    args = (
        flat, jnp.cumsum(nbf) - nbf, jnp.full((N,), bench.C, jnp.int32),
        jnp.repeat(jnp.arange(blocks.shape[0], dtype=jnp.int32),
                   N // blocks.shape[0]),
        *[jnp.asarray(v.astype(np.int32)) for v in
          hb.decode_rows(tb, ARITY_MAX_LEN[arity]).values()],
    )
    got = dk.decode_chunks_kernel(*args, arity=arity, chunk_syms=bench.C)
    ref = dk.decode_chunks_xla(*args, arity=arity, chunk_syms=bench.C)
    assert bool(jnp.array_equal(got, ref))
    assert bool(jnp.array_equal(got.reshape(blocks.shape), blocks))


@pytest.mark.parametrize("arity", [2, 3, 16])
def test_api_matches_host_reference(gpu, arity):
    data = bench.make_corpus(4 << 20, seed=10 + arity)
    cfg = CodecConfig(arity=arity)
    host = CodecConfig(arity=arity, use_device=False)
    blob = api.compress(data, cfg)
    assert blob == api.compress(data, host)
    assert api.decompress(blob) == data
    assert api.decompress(blob, host) == data


def test_device_api_roundtrip(gpu):
    blocks = jnp.asarray(np.frombuffer(bench.make_corpus(64 * bench.S, 3),
                                       np.uint8).reshape(64, bench.S))
    raw = np.full(64, bench.S, np.int64)
    dc = device_api.compress_blocks_device(blocks, raw, CodecConfig(arity=16))
    assert bool(jnp.array_equal(device_api.decompress_blocks_device(dc),
                                blocks))
