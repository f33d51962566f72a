"""The GPU decode kernel (ops/decode_kernel.py) in the Pallas interpreter
against the host oracle (decode_chunk_np) and the plain XLA decode; the
wrapper's tile padding; the one decode-choice function."""

import numpy as np
import pytest

import jax.numpy as jnp

from data_compression_tpu.config import ARITY_MAX_LEN
from data_compression_tpu.huffman.canonical import (
    build_decode_tables,
    lengths_to_codes,
)
from data_compression_tpu.models.huffman import (
    capped_lengths,
    decode_chunk_np,
    encode_chunk_np,
)
from data_compression_tpu.ops import decode_kernel as dk
from tests.conftest import ascii_text


def _corpus(kind, rng, n, C, arity):
    """[n, C] symbols and the frequencies their table is built from."""
    if kind == "deep":
        # steep weights push codes to the per-arity length cap; symbols
        # are drawn uniformly so the deepest codes occur
        if arity == 16:
            freq = [4 ** max(0, 12 - i // 8) for i in range(100)]
        else:
            freq = [1, 1]
            while len(freq) < 40:
                freq.append(freq[-1] + freq[-2])
            freq = freq[::-1]
        k = len(freq)
        data = rng.integers(0, k, size=(n, C)).astype(np.uint8)
        return data, np.asarray(freq + [0] * (256 - k), np.int64)
    if kind == "single":
        data = np.full((n, C), 65, np.uint8)
        return data, np.bincount(data.ravel(), minlength=256)
    data = np.frombuffer(ascii_text(rng, n * C), np.uint8).reshape(n, C)
    return data, np.bincount(data.ravel(), minlength=256)


def _inputs(data, counts, tables, tbl, arity):
    pays = [encode_chunk_np(data[k, : counts[k]], tables[tbl[k]])
            for k in range(data.shape[0])]
    nb = np.asarray([len(p) for p in pays], np.int64)
    starts = (np.cumsum(nb) - nb).astype(np.int32)
    flat = np.frombuffer(b"".join(pays), np.uint8)
    dec = [build_decode_tables(t, pad_to=ARITY_MAX_LEN[arity]) for t in tables]
    tabs = [np.stack([d[k] for d in dec]).astype(np.int32)
            for k in ("limit_scaled", "base_minus_first", "symbols")]
    args = [jnp.asarray(a) for a in (flat, starts, counts, tbl, *tabs)]
    return args, pays


@pytest.mark.parametrize("kind", ["text", "deep", "single", "ragged"])
@pytest.mark.parametrize("arity", [2, 3, 16])
def test_kernel_matches_oracle_and_xla(rng, arity, kind):
    C, n = 64, 20
    data, freq = _corpus("text" if kind == "ragged" else kind, rng, n, C,
                         arity)
    counts = np.full(n, C, np.int32)
    if kind == "ragged":
        counts[-1] = 17  # ragged tail
        counts[3] = 0  # empty chunk
    tables = [lengths_to_codes(capped_lengths(freq, arity), arity),
              lengths_to_codes(capped_lengths(freq * 2 + 1, arity), arity)]
    tbl = (np.arange(n) % 2).astype(np.int32)
    if kind == "deep":
        assert max(t.max_len for t in tables) == ARITY_MAX_LEN[arity]
    args, pays = _inputs(data, counts, tables, tbl, arity)
    got = np.asarray(dk.decode_chunks_kernel(
        *args, arity=arity, chunk_syms=C, interpret=True))
    xla = np.asarray(dk.decode_chunks_xla(*args, arity=arity, chunk_syms=C))
    for k in range(n):
        c = counts[k]
        want = decode_chunk_np(pays[k], c, tables[tbl[k]])
        assert np.array_equal(got[k, :c], want), (arity, kind, k)
        assert np.array_equal(got[k, :c], data[k, :c])
        assert np.array_equal(xla[k, :c], want)


def test_kernel_tile_padding_and_empty_chunks(rng):
    """N that is not a multiple of the 128-chunk tile: the wrapper pads
    with empty lanes and returns exactly [N, C]; empty chunks decode to
    zeros."""
    C, n = 16, dk.TILE + 3
    data = np.frombuffer(ascii_text(rng, n * C), np.uint8).reshape(n, C)
    counts = np.full(n, C, np.int32)
    counts[::5] = 0
    t = lengths_to_codes(
        capped_lengths(np.bincount(data.ravel(), minlength=256), 2), 2)
    args, _ = _inputs(data, counts, [t], np.zeros(n, np.int32), 2)
    got = np.asarray(dk.decode_chunks_kernel(
        *args, arity=2, chunk_syms=C, interpret=True))
    assert got.shape == (n, C)
    full = counts == C
    assert np.array_equal(got[full], data[full])
    assert not got[~full].any()


def test_kernel_empty_payload():
    """Every chunk empty: a zero-byte payload buffer is still readable."""
    t = lengths_to_codes(capped_lengths(np.arange(256) + 1, 2), 2)
    args, _ = _inputs(np.zeros((3, 8), np.uint8), np.zeros(3, np.int32),
                      [t], np.zeros(3, np.int32), 2)
    got = np.asarray(dk.decode_chunks_kernel(
        *args, arity=2, chunk_syms=8, interpret=True))
    assert got.shape == (3, 8) and not got.any()


def test_decode_route():
    assert dk.decode_route("cpu") == "xla"
    assert dk.decode_route("gpu") == "kernel"


def test_decode_chunks_picks_route_and_never_interprets(monkeypatch):
    calls = []
    monkeypatch.setattr(
        dk, "decode_chunks_kernel",
        lambda *a, **kw: calls.append(("kernel", kw["interpret"])),
    )
    monkeypatch.setattr(
        dk, "decode_chunks_xla", lambda *a, **kw: calls.append(("xla", None))
    )
    args = [None] * 7
    dk.decode_chunks(*args, arity=2, chunk_syms=8)
    monkeypatch.setattr(dk.jax, "default_backend", lambda: "gpu")
    dk.decode_chunks(*args, arity=2, chunk_syms=8)
    dk.decode_chunks(*args, arity=2, chunk_syms=8, interpret=True)
    assert calls == [("xla", None), ("kernel", False), ("kernel", True)]


def test_corrupt_cursor_stays_in_buffer(rng):
    """Garbage payload bytes: the kernel reads only inside its buffer and
    returns a result (the frame CRC rejects it later)."""
    C, n = 32, 4
    t = lengths_to_codes(capped_lengths(np.arange(256) + 1, 2), 2)
    flat = rng.integers(0, 256, 7, dtype=np.uint8)
    args = [jnp.asarray(a) for a in (
        flat, np.asarray([0, 3, 6, 7], np.int32), np.full(n, C, np.int32),
        np.zeros(n, np.int32))]
    d = build_decode_tables(t, pad_to=ARITY_MAX_LEN[2])
    tabs = [jnp.asarray(d[k][None].astype(np.int32))
            for k in ("limit_scaled", "base_minus_first", "symbols")]
    got = dk.decode_chunks_kernel(*args, *tabs, arity=2, chunk_syms=C,
                                  interpret=True)
    assert got.shape == (n, C)
