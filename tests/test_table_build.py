"""On-device table construction (ops/table_build.py) vs the host
tables: bit-identical lengths, encode tables, and decode tables."""

import numpy as np
import pytest

import jax.numpy as jnp

from data_compression_tpu.config import ARITY_MAX_LEN
from data_compression_tpu.huffman import batched as hb
from data_compression_tpu.ops import table_build as tbd

from tests.test_table_batch import _hist_suite


@pytest.mark.parametrize("arity", [2, 3, 16])
def test_device_lengths_match_host(rng, arity):
    hists = _hist_suite(rng)
    host = hb.capped_lengths_batch(hists, arity)
    dev = np.asarray(
        tbd.huffman_lengths_device(jnp.asarray(hists.astype(np.int32)), arity)
    )
    assert np.array_equal(host, dev)


@pytest.mark.parametrize("arity", [2, 3, 16])
def test_device_tables_match_host(rng, arity):
    hists = _hist_suite(rng)
    lens = hb.capped_lengths_batch(hists, arity)
    tb = hb.codes_batch(lens, arity)
    L = ARITY_MAX_LEN[arity]

    packed_d, bits_d = tbd.encode_tables_device(jnp.asarray(lens), arity)
    pt, bt = hb.packed_rows(tb)
    assert np.array_equal(np.asarray(packed_d), pt)
    assert np.array_equal(np.asarray(bits_d), bt)

    dr = hb.decode_rows(tb, L)
    lim, bmf, syms = tbd.decode_tables_device(jnp.asarray(lens), arity, L)
    assert np.array_equal(np.asarray(lim), dr["limit_scaled"].astype(np.int32))
    assert np.array_equal(
        np.asarray(bmf), dr["base_minus_first"].astype(np.int32)
    )
    assert np.array_equal(np.asarray(syms), dr["symbols"])
