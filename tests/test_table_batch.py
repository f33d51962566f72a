"""Differential tests: batched host table machinery (huffman/batched.py
+ the native C length builder) vs the per-block reference path
(huffman/tree.py + canonical.py) — bit-identical, by construction of
the wire format."""

import numpy as np
import pytest

from data_compression_tpu.config import ARITY_MAX_LEN
from data_compression_tpu.huffman import batched as hb
from data_compression_tpu.huffman.canonical import (
    build_decode_tables,
    lengths_to_codes,
)
from data_compression_tpu.models.huffman import capped_lengths


def _hist_suite(rng, n=40):
    """Random + pathological histograms: zipf text, sparse, singleton,
    empty, flat, Fibonacci (deep tree — forces the cap rescale)."""
    out = []
    for i in range(n):
        kind = i % 6
        if kind == 0:
            h = rng.integers(0, 1000, 256)
        elif kind == 1:
            h = np.bincount(rng.zipf(1.3, 65536).clip(1, 256) - 1, minlength=256)
        elif kind == 2:
            h = np.zeros(256, int)
            h[rng.choice(256, int(rng.integers(1, 5)), replace=False)] = (
                rng.integers(1, 100)
            )
        elif kind == 3:
            h = np.zeros(256, int)
            h[int(rng.integers(0, 256))] = 7
        elif kind == 4:
            h = np.zeros(256, int)
        else:
            h = np.zeros(256, int)
            fib = [1, 1]
            for _ in range(20):
                fib.append(fib[-1] + fib[-2])
            h[:22] = fib[:22]
        out.append(h)
    return np.asarray(out, np.int64)


@pytest.mark.parametrize("arity", [2, 3, 16, 10])
def test_capped_lengths_batch_matches_reference(rng, arity):
    hists = _hist_suite(rng)
    lens = hb.capped_lengths_batch(hists, arity)
    for i in range(hists.shape[0]):
        assert np.array_equal(lens[i], capped_lengths(hists[i], arity))


def test_capped_lengths_python_fallback_matches_native(rng, monkeypatch):
    from data_compression_tpu import native

    hists = _hist_suite(rng, n=12)
    want = hb.capped_lengths_batch(hists, 3)
    monkeypatch.setattr(native, "huffman_capped_lengths_batch", lambda *a: None)
    assert np.array_equal(hb.capped_lengths_batch(hists, 3), want)


@pytest.mark.parametrize("arity", [2, 3, 16])
def test_codes_batch_matches_reference(rng, arity):
    hists = _hist_suite(rng)
    L = ARITY_MAX_LEN[arity]
    lens = hb.capped_lengths_batch(hists, arity)
    tb = hb.codes_batch(lens, arity)
    dr = hb.decode_rows(tb, L)
    ptb, btb = hb.packed_rows(tb)
    from data_compression_tpu.ops.encode_fast import pack_encode_table

    for i in range(hists.shape[0]):
        ref = lengths_to_codes(lens[i], arity)
        assert np.array_equal(tb.codes[i], ref.codes)
        ct = tb.table(i)
        assert ct.max_len == ref.max_len and ct.min_len == ref.min_len
        assert np.array_equal(ct.sorted_symbols, ref.sorted_symbols)
        assert np.array_equal(ct.first_code, ref.first_code)
        pt, bt = pack_encode_table(ref)
        assert np.array_equal(ptb[i], pt) and np.array_equal(btb[i], bt)
        d = build_decode_tables(ref, pad_to=L)
        assert np.array_equal(dr["limit_scaled"][i], d["limit_scaled"])
        assert np.array_equal(dr["base_minus_first"][i], d["base_minus_first"])
        assert np.array_equal(dr["symbols"][i], d["symbols"])


def test_codes_batch_kraft_violation(rng):
    bad = np.zeros((1, 256), np.int32)
    bad[0, :4] = 1  # four 1-digit binary codes: impossible
    with pytest.raises(ValueError, match="Kraft"):
        hb.codes_batch(bad, 2)


@pytest.mark.parametrize("arity", [2, 3, 16])
def test_packed_rows_matches_pack_encode_table(rng, arity):
    from data_compression_tpu.ops.encode_fast import pack_encode_table

    hists = _hist_suite(rng, n=18)
    lens = hb.capped_lengths_batch(hists, arity)
    tb = hb.codes_batch(lens, arity)
    pt, bt = hb.packed_rows(tb)
    for i in range(lens.shape[0]):
        p1, b1 = pack_encode_table(lengths_to_codes(lens[i], arity))
        assert np.array_equal(pt[i], p1)
        assert np.array_equal(bt[i], b1)
