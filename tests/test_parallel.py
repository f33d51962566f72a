"""Sharded pipeline on the virtual CPU mesh: 1-D and 2-D mesh
round-trips, equivalence with the single-device stream, shared-table
all-reduce, and the 4-device mesh of a four-card host."""

import jax
import numpy as np
import pytest

from data_compression_tpu import compress
from data_compression_tpu.config import CodecConfig
from data_compression_tpu.parallel.mesh import make_mesh
from data_compression_tpu.parallel.pipeline import (
    compress_sharded,
    decompress_sharded,
)
from tests.conftest import ascii_text


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    return ascii_text(rng, 96 * 1024)


def test_eight_devices_available():
    assert len(jax.devices()) == 8, "conftest must provide 8 virtual devices"


@pytest.mark.parametrize("shape", [(8, 1), (4, 2), (2, 4)])
def test_sharded_roundtrip(data, shape):
    mesh = make_mesh(shape=shape)
    cfg = CodecConfig(codec="huffman", arity=2, block_size=8192, chunk_syms=1024)
    out = compress_sharded(data, cfg, mesh)
    back = decompress_sharded(out, CodecConfig(chunk_syms=1024), mesh)
    assert back == data


def test_sharded_stream_equals_single_device_stream(data):
    """The sharded pipeline must be deterministic: byte-identical frame
    regardless of mesh shape, and identical to the unsharded API."""
    cfg = CodecConfig(codec="huffman", arity=2, block_size=8192, chunk_syms=1024)
    one = compress(data, cfg)
    for shape in [(8, 1), (2, 4)]:
        sharded = compress_sharded(data, cfg, make_mesh(shape=shape))
        assert sharded == one, f"mesh {shape} produced a different stream"


def test_sharded_shared_table(data):
    mesh = make_mesh(shape=(4, 2))
    cfg = CodecConfig(
        codec="huffman", arity=3, block_size=8192, chunk_syms=1024, shared_table=True
    )
    out = compress_sharded(data, cfg, mesh)
    back = decompress_sharded(out, CodecConfig(chunk_syms=1024), mesh)
    assert back == data
    # one table in frame, none per block
    from data_compression_tpu import framing

    frame = framing.unpack_frame(out)
    assert frame.shared_table is not None


def test_sharded_ragged_tail(rng):
    # total not a multiple of block size nor of device count
    data = ascii_text(rng, 37 * 1024 + 123)
    mesh = make_mesh(shape=(8, 1))
    cfg = CodecConfig(codec="huffman", arity=2, block_size=4096, chunk_syms=512)
    out = compress_sharded(data, cfg, mesh)
    assert decompress_sharded(out, CodecConfig(chunk_syms=512), mesh) == data


@pytest.mark.parametrize("arity,shared", [(2, False), (3, True), (16, False)])
def test_sharded_four_device_mesh(data, arity, shared):
    """The (4, 1) mesh of a four-card host: the stream equals the
    single-device api.compress stream and decodes back, per-block and
    shared-table (the histogram all-reduce) modes."""
    mesh = make_mesh(shape=(4, 1), devices=jax.devices()[:4])
    cfg = CodecConfig(codec="huffman", arity=arity, block_size=8192,
                      chunk_syms=512, shared_table=shared)
    out = compress_sharded(data, cfg, mesh)
    assert out == compress(data, cfg)
    assert decompress_sharded(out, CodecConfig(chunk_syms=512), mesh) == data
