"""High-level compress/decompress API.

The reference's only API is ``main()`` reading stdin in 65,000-byte
blocks (n_ary_huffman.c:2508-2580).  This module is the equivalent
driver: split → encode blocks (device-parallel inside the codec) →
apply the universal LITERAL fallback → frame; and the inverse with
per-block CRC verification.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np

from data_compression_tpu import framing
from data_compression_tpu.config import CodecConfig
from data_compression_tpu.registry import get_codec
from data_compression_tpu.utils.crc import crc32, crc32_blocks

BytesLike = Union[bytes, bytearray, memoryview, np.ndarray]


def _as_bytes(data: BytesLike) -> bytes:
    if isinstance(data, np.ndarray):
        return np.ascontiguousarray(data, dtype=np.uint8).tobytes()
    return bytes(data)


STATS_CODECS = ("nybble", "small_byte", "small_nybble")


def compress(
    data: BytesLike,
    config: Optional[CodecConfig] = None,
    meta: Optional[bytes] = None,
    printable: bool = False,
    stats=None,
) -> bytes:
    """Compress a byte stream into a framed container.

    ``meta`` attaches an annotation block decoders skip — the
    reference's '#' meta netstring (n_ary_huffman.c:2058, design note
    :75-78): raw_len 0, crc of the annotation bytes themselves.

    ``printable=True`` emits the in-band printable container — the
    reference's reserved-but-unimplemented '_' mode
    (small_compression.c:35-40): every block payload is an independent
    Z85 span, so the whole stream is isprint text and blocks stay
    independently locatable (framing.frame_to_printable).

    ``stats``: optional utils.debug.CodecStats collecting per-context
    prediction/dictionary hit counters during encode (the reference's
    times_used_directly, nybble_compression.c:543).  Supported by the
    serial codecs (STATS_CODECS); collection routes their encode
    through the host path (bit-identical payloads)."""
    config = config or CodecConfig()
    raw = _as_bytes(data)
    blocks, lengths = framing.split_blocks(raw, config.block_size)
    codec = get_codec(config)
    if stats is not None:
        if config.codec not in STATS_CODECS:
            raise ValueError(
                f"stats collection supports codecs {STATS_CODECS}, "
                f"not {config.codec!r}"
            )
        result = codec.encode_blocks(blocks, lengths, stats=stats)
    else:
        result = codec.encode_blocks(blocks, lengths)

    payloads, flags, crcs = [], [], []
    raw_lens = []
    if meta is not None:
        payloads.append(bytes(meta))
        flags.append(framing.BLOCK_META)
        crcs.append(crc32(bytes(meta)))
        raw_lens.append(0)
    block_crcs = crc32_blocks(blocks, lengths)  # batched, no copies
    for i, payload in enumerate(result.payloads):
        raw_len = int(lengths[i])
        crcs.append(int(block_crcs[i]))
        # Universal LITERAL fallback: store raw when compression loses
        # (reference rule, e.g. nybble_compression.c:1018-1037).
        if len(payload) >= raw_len and config.codec != "literal":
            payloads.append(blocks[i, :raw_len].tobytes())
            flags.append(framing.BLOCK_LITERAL)
        else:
            payloads.append(payload)
            flags.append(0)
        raw_lens.append(raw_len)

    chunk_log2 = (
        config.chunk_syms.bit_length() - 1 if config.codec == "huffman" else 0
    )
    frame = framing.pack_frame(
        codec_id=config.codec_id,
        arity=config.arity,
        block_size=config.block_size,
        total_len=len(raw),
        payloads=payloads,
        raw_lens=raw_lens,
        crcs=crcs,
        block_flags=flags,
        shared_table=result.shared_table,
        chunk_log2=chunk_log2,
    )
    return framing.frame_to_printable(frame) if printable else frame


def decompress(data: BytesLike, config: Optional[CodecConfig] = None) -> bytes:
    """Decompress a framed container (binary or in-band printable —
    auto-detected by magic). ``config`` may override runtime execution
    knobs (use_device); format parameters come from the frame."""
    raw = _as_bytes(data)
    if raw.startswith(framing.PRINTABLE_MAGIC):
        raw = framing.printable_to_frame(raw)
    frame = framing.unpack_frame(raw)
    chunk_syms = frame.chunk_syms or min(4096, frame.block_size)
    cfg = CodecConfig(
        codec=frame.codec_name,
        arity=frame.arity if frame.codec_name == "huffman" else 2,
        block_size=frame.block_size,
        chunk_syms=chunk_syms,
        shared_table=frame.shared_table is not None,
        use_device=(config.use_device if config else True),
        use_scan=(config.use_scan if config else False),
    )
    codec = get_codec(cfg)

    coded_idx = [
        i for i, e in enumerate(frame.entries)
        if not e.is_literal and not e.is_meta
    ]
    out: list = [None] * len(frame.entries)
    for i, e in enumerate(frame.entries):
        if e.is_meta:
            # annotation block: decoders skip (reference's '#' netstring)
            if crc32(frame.payloads[i]) != e.crc:
                raise ValueError(f"block {i}: meta CRC mismatch")
            out[i] = b""
        elif e.is_literal:
            out[i] = frame.payloads[i]
    if coded_idx:
        decoded = codec.decode_blocks(
            [frame.payloads[i] for i in coded_idx],
            [frame.entries[i].raw_len for i in coded_idx],
            shared_table=frame.shared_table,
        )
        for i, blk in zip(coded_idx, decoded):
            out[i] = blk

    for i, e in enumerate(frame.entries):
        if e.is_meta:
            continue  # verified above; contributes no output bytes
        if len(out[i]) != e.raw_len:
            raise ValueError(f"block {i}: decoded length {len(out[i])} != {e.raw_len}")
        if crc32(out[i]) != e.crc:
            raise ValueError(f"block {i}: CRC mismatch (corrupt stream?)")
    result = b"".join(out)
    if len(result) != frame.total_len:
        raise ValueError("total length mismatch")
    return result


def roundtrip(data: BytesLike, config: Optional[CodecConfig] = None) -> bool:
    """The universal oracle of the reference's tests: compress →
    decompress → memcmp (e.g. nybble_compression.c:1166-1173)."""
    return decompress(compress(data, config), config) == _as_bytes(data)


# ----------------------------------------------------------------------
# Streaming drivers: bounded-memory IO over unbounded inputs
# ----------------------------------------------------------------------

DEFAULT_BATCH_BLOCKS = 256  # 16 MiB resident per batch at 64 KiB blocks


def compress_stream(
    fin,
    fout,
    config: Optional[CodecConfig] = None,
    batch_blocks: int = DEFAULT_BATCH_BLOCKS,
    printable: bool = False,
    stats=None,
) -> dict:
    """Compress a binary stream into a concatenation of independent
    frames, holding at most ``batch_blocks`` blocks of input resident.

    The reference never holds its input either — it loops 65,000-byte
    blocks off stdin (n_ary_huffman.c:2508-2580, load_more_text
    :1260-1294).  Here the bounded unit is a batch of blocks so the
    device still sees large parallel batches; a 1 GB+ input costs
    ~batch_blocks x block_size resident, not 2 x the file.

    ``printable=True`` armors each frame as an independent in-band
    printable container (framing.frame_to_printable), so unbounded
    inputs stream to all-isprint output; decompress_stream consumes
    either form (framing.read_frame auto-detects per frame)."""
    config = config or CodecConfig()
    batch_bytes = batch_blocks * config.block_size
    total_in = 0
    total_out = 0
    frames = 0
    while True:
        chunk = fin.read(batch_bytes)
        if not chunk:
            break
        out = compress(chunk, config, printable=printable, stats=stats)
        fout.write(out)
        total_in += len(chunk)
        total_out += len(out)
        frames += 1
    if frames == 0:  # empty input still yields one valid (empty) frame
        out = compress(b"", config, printable=printable, stats=stats)
        fout.write(out)
        total_out += len(out)
        frames = 1
    return {
        "raw_bytes": total_in,
        "compressed_bytes": total_out,
        "frames": frames,
        "ratio": total_out / max(1, total_in),
    }


def decompress_stream(fin, fout, config: Optional[CodecConfig] = None) -> dict:
    """Inverse of compress_stream: consume frames one at a time, so
    resident memory is bounded by one frame (one batch), not the file."""
    total_in = 0
    total_out = 0
    frames = 0
    while True:
        frame_bytes = framing.read_frame(fin)
        if frame_bytes is None:
            break
        out = decompress(frame_bytes, config)
        fout.write(out)
        total_in += len(frame_bytes)
        total_out += len(out)
        frames += 1
    if frames == 0:
        raise ValueError("empty input: no frames")
    return {
        "compressed_bytes": total_in,
        "raw_bytes": total_out,
        "frames": frames,
    }


def compress_file(
    src: str,
    dst: str,
    config: Optional[CodecConfig] = None,
    streaming: Optional[bool] = None,
    batch_blocks: int = DEFAULT_BATCH_BLOCKS,
) -> dict:
    """File driver.  ``streaming=None`` auto-selects: files larger than
    one batch stream through bounded memory; smaller files produce the
    single-frame container (identical bytes to compress())."""
    config = config or CodecConfig()
    import os

    if streaming is None:
        streaming = os.path.getsize(src) > batch_blocks * config.block_size
    with open(src, "rb") as f:
        if streaming:
            with open(dst, "wb") as g:
                return compress_stream(f, g, config, batch_blocks)
        data = f.read()
    out = compress(data, config)
    with open(dst, "wb") as f:
        f.write(out)
    return {
        "raw_bytes": len(data),
        "compressed_bytes": len(out),
        "ratio": len(out) / max(1, len(data)),
    }


def decompress_file(
    src: str, dst: str, config: Optional[CodecConfig] = None
) -> dict:
    """File driver; always consumes frame-by-frame (bounded memory, and
    a single-frame container is just the one-iteration case)."""
    with open(src, "rb") as f, open(dst, "wb") as g:
        return decompress_stream(f, g, config)
