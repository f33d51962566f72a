"""Payload-corruption fuzzing: random bit flips and truncations inside
block payloads must surface as a clean ValueError (usually the
per-block CRC32, framing.py layout), NEVER a crash, hang, or OOB read —
for every codec, on both the Python and native host paths.

The reference's only resilience idea is a comment sketching per-block
checksums (small_compression.c:911-931); its actual error-handling
strategy is assert() (n_ary_huffman.c:1956-1958).  This suite is the
framework's fault-injection story (SURVEY.md §5 failure detection).

Run `make test-asan` to execute the same native decoders under
ASan/UBSan; dct_huffman_decode_chunk additionally bound-checks the
canonical rank in C (libdctpu.c) so even Kraft-invalid tables cannot
index out of the 256-entry symbol array.
"""

import zlib

import numpy as np
import pytest

from data_compression_tpu import compress, decompress
from data_compression_tpu.config import CodecConfig
from tests.conftest import ascii_text

CONFIGS = [
    ("huffman2", CodecConfig(codec="huffman", arity=2, block_size=8192,
                             chunk_syms=512, use_device=False)),
    ("huffman3", CodecConfig(codec="huffman", arity=3, block_size=8192,
                             chunk_syms=512, use_device=False)),
    ("huffman16", CodecConfig(codec="huffman", arity=16, block_size=8192,
                              chunk_syms=512, use_device=False)),
    ("nybble", CodecConfig(codec="nybble", block_size=8192, use_device=False)),
    ("small_byte", CodecConfig(codec="small_byte", block_size=8192,
                               use_device=False)),
    ("small_nybble", CodecConfig(codec="small_nybble", block_size=4096,
                                 use_device=False)),
    ("literal", CodecConfig(codec="literal", block_size=8192,
                            use_device=False)),
]


def _payload_region(stream: bytes) -> tuple:
    """(start, end) of the block-payload bytes in a DCTZ frame — skip
    the 32-byte header and block table so flips hit codec payloads,
    not just the (already tested) header CRC."""
    import struct

    from data_compression_tpu import framing

    nblocks = struct.unpack_from("<I", stream, 14)[0]
    flags = struct.unpack_from("<H", stream, 6)[0]
    off = framing._HEADER.size
    if flags & framing.FLAG_SHARED_TABLE:
        (tlen,) = struct.unpack_from("<I", stream, off)
        off += 4 + tlen
    off += nblocks * framing._ENTRY.size
    return off, len(stream)


@pytest.mark.parametrize("name,cfg", CONFIGS, ids=[c[0] for c in CONFIGS])
def test_bitflip_fuzz(name, cfg):
    # deterministic seed: hash() is randomized per process by
    # PYTHONHASHSEED, which made failures non-reproducible (ADVICE r3)
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    size = 3 * cfg.block_size // 2  # two blocks, one partial
    data = ascii_text(rng, size)
    stream = bytearray(compress(data, cfg))
    lo, hi = _payload_region(bytes(stream))
    assert hi > lo, "frame has no payload region?"
    for trial in range(40):
        corrupt = bytearray(stream)
        nflips = int(rng.integers(1, 4))
        for _ in range(nflips):
            pos = int(rng.integers(lo, hi))
            corrupt[pos] ^= 1 << int(rng.integers(0, 8))
        try:
            out = decompress(bytes(corrupt), cfg)
            # extraordinarily unlikely: flips must not silently pass CRC
            assert out == data, f"{name}: silent corruption escaped CRC"
        except ValueError:
            pass  # the required clean failure


@pytest.mark.parametrize("name,cfg", CONFIGS, ids=[c[0] for c in CONFIGS])
def test_truncation_fuzz(name, cfg):
    rng = np.random.default_rng(1 + zlib.crc32(name.encode()))
    data = ascii_text(rng, cfg.block_size + 100)
    stream = compress(data, cfg)
    for frac in (0.25, 0.5, 0.9, 0.99):
        cut = stream[: int(len(stream) * frac)]
        with pytest.raises(ValueError):
            decompress(cut, cfg)


def test_native_huffman_decode_oob_guard():
    """Direct native fuzz: corrupted chunk payloads through
    dct_huffman_decode_chunk must return an error or wrong bytes —
    never read outside the 256-entry symbol table (the C-side sidx
    bound; under make test-asan this also proves no OOB)."""
    from data_compression_tpu import native

    if native.load() is None:
        pytest.skip("native lib unavailable")
    from data_compression_tpu.huffman.canonical import (
        build_decode_tables,
        lengths_to_codes,
    )
    from data_compression_tpu.models.huffman import capped_lengths
    from data_compression_tpu.ops.encode_fast import pack_encode_table

    rng = np.random.default_rng(3)
    data = ascii_text(rng, 512)
    freqs = np.bincount(np.frombuffer(data, np.uint8), minlength=256)
    table = lengths_to_codes(capped_lengths(freqs, 2), 2)
    pt, bt = pack_encode_table(table)
    payload = native.huffman_encode_chunk(np.frombuffer(data, np.uint8), pt, bt, 2)
    dec = build_decode_tables(table, pad_to=15)
    for _ in range(200):
        corrupt = bytearray(payload)
        for _ in range(int(rng.integers(1, 6))):
            corrupt[int(rng.integers(0, len(corrupt)))] ^= int(
                rng.integers(1, 256)
            )
        try:
            native.huffman_decode_chunk(bytes(corrupt), 512, dec, 2, 15)
        except ValueError:
            pass  # DCT_ERR_FORMAT surfaced cleanly


def test_native_small_and_nybble_corrupt_streams():
    from data_compression_tpu import native

    if native.load() is None:
        pytest.skip("native lib unavailable")
    rng = np.random.default_rng(4)
    data = ascii_text(rng, 2000)
    small = native.small_byte_encode(data)
    nyb = native.nybble_encode(data)
    for stream, dec, raw_len in (
        (small, native.small_byte_decode, len(data)),
        (nyb, native.nybble_decode, len(data)),
    ):
        for _ in range(100):
            corrupt = bytearray(stream)
            for _ in range(int(rng.integers(1, 4))):
                corrupt[int(rng.integers(0, len(corrupt)))] ^= int(
                    rng.integers(1, 256)
                )
            try:
                dec(bytes(corrupt), raw_len)
            except ValueError:
                pass


def test_bitflip_device_parse_path(rng):
    """The vectorized device-path payload parse (round 4,
    HuffmanCodec._parse_payloads_vec) must honor the same corruption
    contract as the host parser: every bit flip either roundtrips to a
    clean ValueError or is caught by the per-block CRC."""
    import zlib

    from data_compression_tpu.api import compress, decompress
    from data_compression_tpu.config import CodecConfig

    cfg = CodecConfig(codec="huffman", arity=2, block_size=4096,
                      chunk_syms=512, use_device=True)
    letters = np.frombuffer(b" etaoinshrdlcu.,\n", np.uint8)
    data = rng.choice(letters, size=3 * 4096 + 99).tobytes()
    blob = bytearray(compress(data, cfg))
    assert decompress(bytes(blob), cfg) == data
    rs = np.random.default_rng(zlib.crc32(b"device-parse"))
    for _ in range(40):
        pos = int(rs.integers(32, len(blob)))  # past the header
        bit = 1 << int(rs.integers(0, 8))
        blob[pos] ^= bit
        try:
            out = decompress(bytes(blob), cfg)
            assert out == data, "corruption silently accepted"
        except ValueError:
            pass
        finally:
            blob[pos] ^= bit


def test_bitflip_printable_container(rng):
    # printable container corruption: armor damage, header damage, or
    # payload damage must all surface as ValueError (z85 parse, header
    # CRC, or block CRC) — never a crash or silent pass
    cfg = CodecConfig(codec="huffman", arity=2, block_size=4096,
                      chunk_syms=512, use_device=False)
    data = ascii_text(rng, 3 * 4096 // 2)
    blob = bytearray(compress(data, cfg, printable=True))
    for trial in range(40):
        corrupt = bytearray(blob)
        pos = int(rng.integers(len(b"DCTP1\n"), len(corrupt)))
        corrupt[pos] ^= 1 << int(rng.integers(0, 8))
        try:
            out = decompress(bytes(corrupt), cfg)
            assert out == data, "printable: silent corruption escaped"
        except ValueError:
            pass


def test_bitflip_isprint_mode(rng):
    # the 0x1f block mode's decoder under payload corruption
    cfg = CodecConfig(codec="small_byte", block_size=2048, chunk_syms=1024,
                      use_device=False, isprint_literal=True)
    data = bytes(rng.integers(0x20, 0x7F, size=3000, dtype=np.uint8))
    stream = bytearray(compress(data, cfg))
    lo, hi = _payload_region(bytes(stream))
    for trial in range(40):
        corrupt = bytearray(stream)
        pos = int(rng.integers(lo, hi))
        corrupt[pos] ^= 1 << int(rng.integers(0, 8))
        try:
            out = decompress(bytes(corrupt), cfg)
            assert out == data, "isprint: silent corruption escaped CRC"
        except ValueError:
            pass


def test_truncation_printable_stream(rng):
    # streamed printable containers: truncation anywhere raises cleanly
    import io

    from data_compression_tpu import api

    cfg = CodecConfig(codec="huffman", arity=2, block_size=1024,
                      chunk_syms=512, use_device=False)
    data = ascii_text(rng, 5 * 1024)
    buf = io.BytesIO()
    api.compress_stream(io.BytesIO(data), buf, cfg, batch_blocks=2,
                        printable=True)
    blob = buf.getvalue()
    for frac in (0.1, 0.5, 0.9, 0.999):
        cut = blob[: int(len(blob) * frac)]
        with pytest.raises(ValueError):
            api.decompress_stream(io.BytesIO(cut), io.BytesIO(), cfg)
