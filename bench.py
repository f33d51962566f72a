"""Benchmark: the codec family on the GPU.

Prints ONE JSON line: {"metric", "value", "unit", "device", "detail"}.
The headline metric is the huffman-2 device encode rate (histogram-built
tables, merge-tree encode + payload compaction in one jit) in GB/s of
input.  ``detail`` carries device decode (the GPU kernel), arity 3/16,
the device-resident pipeline (device_api), the host-bytes end-to-end
(api.compress / api.decompress), the serial codecs' production host
paths, their opt-in scan demos, and a real-corpus datapoint (the repo's
own source, the reference Makefile's trick).

Every device number is a median over repeated calls that end in
``block_until_ready``; ``device`` names the platform, device kind and
count, and the card's name and power limit.  Without a GPU it exits
non-zero: a measurement never falls back to the CPU.

Corpus: synthetic English-like text with enwik8-like symbol statistics
(Zipf-weighted letters; entropy ~4.2 bits/byte), made from a seed.

``python bench.py --smoke`` runs a CPU-only subset on a 1 MiB corpus
(exercised by tests/test_bench_smoke.py so entry-signature drift can
never ship a broken bench).
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

HEADLINE_MB = 64
SMALL_MB = 8
SCAN_MB = 2  # serial scan codecs: one lax.scan step per byte
SERIAL_MB = 4  # serial codecs' production host paths
S = 65536
C = 512


def make_corpus(nbytes: int, seed: int = 0) -> bytes:
    rng = np.random.default_rng(seed)
    # enwik8-ish: letters + space + punctuation + markup chars, zipfish
    alphabet = np.frombuffer(
        b" etaoinshrdlcumwfgypbvk'\"<>/=.,;:[]|()&#x1230984756-_\nqjzETAOINSHR",
        np.uint8,
    )
    ranks = np.arange(1, alphabet.size + 1, dtype=np.float64)
    probs = 1.0 / ranks**1.1
    probs /= probs.sum()
    return rng.choice(alphabet, size=nbytes, p=probs).tobytes()


def median_s(fn, *args, iters: int = 5) -> float:
    """Median wall seconds of fn(*args) to block_until_ready, after one
    warm-up call (which compiles)."""
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def _prep_huffman(data: bytes, arity: int):
    """Blocks on the device, per-block tables from host histograms."""
    import jax
    import jax.numpy as jnp

    from data_compression_tpu import framing
    from data_compression_tpu.huffman import batched as hb
    from data_compression_tpu.ops.compaction import round_cap
    from data_compression_tpu.config import ARITY_DIGITS_PER_BYTE

    blocks, lengths = framing.split_blocks(data, S)
    hists = np.stack(
        [np.bincount(blocks[i, : lengths[i]], minlength=256)
         for i in range(blocks.shape[0])]
    ).astype(np.int64)
    tb = hb.codes_batch(hb.capped_lengths_batch(hists, arity), arity)
    pt, bt = hb.packed_rows(tb)
    D = ARITY_DIGITS_PER_BYTE[arity]
    bound = int((-(-(hists * tb.lengths.astype(np.int64)).sum(1) // D)).sum())
    cap = round_cap(bound + blocks.shape[0] * (S // C))
    args = (jax.device_put(blocks), jnp.asarray(lengths, jnp.int32),
            jnp.asarray(pt), jnp.asarray(bt))
    return args, tb, cap


def bench_huffman_encode(data: bytes, arity: int):
    from data_compression_tpu.ops.encode_fast import encode_blocks_compact

    args, _, cap = _prep_huffman(data, arity)

    def enc(*a):
        return encode_blocks_compact(*a, arity=arity, chunk_syms=C,
                                     out_cap=cap)

    sec = median_s(enc, *args)
    _, nb = enc(*args)
    return len(data) / sec / 1e9, int(np.asarray(nb).sum()) / len(data)


def bench_huffman_decode(data: bytes, arity: int = 2):
    """The decode of api.decompress and device_api on the device:
    ops/decode_kernel.decode_chunks over the compacted stream."""
    import jax.numpy as jnp

    from data_compression_tpu.config import ARITY_MAX_LEN
    from data_compression_tpu.huffman import batched as hb
    from data_compression_tpu.ops.decode_kernel import decode_chunks
    from data_compression_tpu.ops.encode_fast import encode_blocks_compact

    args, tb, cap = _prep_huffman(data, arity)
    flat, nb = encode_blocks_compact(*args, arity=arity, chunk_syms=C,
                                     out_cap=cap)
    nbf = nb.reshape(-1)
    starts = jnp.cumsum(nbf) - nbf
    counts = jnp.clip(
        args[1][:, None] - jnp.arange(S // C, dtype=jnp.int32)[None, :] * C,
        0, C,
    ).reshape(-1)
    tbl = jnp.repeat(jnp.arange(nb.shape[0], dtype=jnp.int32), S // C)
    dr = hb.decode_rows(tb, ARITY_MAX_LEN[arity])
    tabs = [jnp.asarray(dr[k].astype(np.int32))
            for k in ("limit_scaled", "base_minus_first", "symbols")]

    def dec(*a):
        return decode_chunks(*a, arity=arity, chunk_syms=C)

    sec = median_s(dec, flat, starts, counts, tbl, *tabs)
    out = dec(flat, starts, counts, tbl, *tabs)
    assert bool(jnp.array_equal(out.reshape(args[0].shape), args[0]))
    return len(data) / sec / 1e9


def bench_e2e_device(data: bytes, arity: int = 2):
    """device_api round trip on device-resident blocks: histogram,
    on-device table build, encode + compaction; then the decode back.
    -> (compress GB/s, decompress GB/s)."""
    import jax
    import jax.numpy as jnp

    from data_compression_tpu import device_api
    from data_compression_tpu.config import CodecConfig

    dev = jax.device_put(np.frombuffer(data, np.uint8).reshape(-1, S))
    raw = np.full(dev.shape[0], S, np.int64)
    cfg = CodecConfig(arity=arity)

    def comp(x):
        dc = device_api.compress_blocks_device(x, raw, cfg)
        return dc.flat, dc.nb

    csec = median_s(comp, dev, iters=3)
    dc = device_api.compress_blocks_device(dev, raw, cfg)
    dsec = median_s(device_api.decompress_blocks_device, dc, iters=3)
    assert bool(jnp.array_equal(device_api.decompress_blocks_device(dc), dev))
    return len(data) / csec / 1e9, len(data) / dsec / 1e9


def bench_serial_host(mb: int = SERIAL_MB) -> dict:
    """Production host paths of the serial-state codecs, through the
    full API (framing + CRC included): native C, OpenMP across blocks."""
    import data_compression_tpu as dct

    out = {}
    data = make_corpus(mb * 1024 * 1024, seed=2)
    for codec in ("nybble", "small_byte", "small_nybble"):
        cfg = dct.CodecConfig(codec=codec)
        blob = dct.compress(data, cfg)  # warm (builds native lib)
        t0 = time.perf_counter()
        blob = dct.compress(data, cfg)
        t1 = time.perf_counter()
        back = dct.decompress(blob)
        t2 = time.perf_counter()
        back = dct.decompress(blob)
        t3 = time.perf_counter()
        assert back == data
        out[f"{codec}_encode_gbps"] = round(len(data) / (t1 - t0) / 1e9, 4)
        out[f"{codec}_decode_gbps"] = round(len(data) / (t3 - t2) / 1e9, 4)
        out[f"{codec}_ratio"] = round(len(blob) / len(data), 4)
    return out


def bench_nybble_scan_decode(data: bytes):
    """Opt-in lax.scan decode demo (one scan step per output byte;
    parallel across block lanes) — NOT the production path."""
    import jax.numpy as jnp

    from data_compression_tpu.models.nybble import encode_host
    from data_compression_tpu.ops import scan_codecs as sc
    from data_compression_tpu import framing

    blocks, lengths = framing.split_blocks(data, S)
    payloads = [
        encode_host(blocks[i, : lengths[i]].tobytes())
        for i in range(blocks.shape[0])
    ]
    # type byte stripped: lane payload[0] is the verbatim first byte
    P = -(-max(len(p) - 1 for p in payloads) // 512) * 512
    pay = np.zeros((len(payloads), P), np.uint8)
    for i, p in enumerate(payloads):
        body = np.frombuffer(p, np.uint8)[1:]
        pay[i, : body.size] = body
    payj = jnp.asarray(pay.astype(np.int32))
    rls = jnp.asarray(np.asarray(lengths, np.int32))
    sec = median_s(lambda p, r: sc._decode_batch(p, r, S), payj, rls,
                   iters=2)
    return len(data) / sec / 1e9


def bench_end_to_end(data: bytes, trials: int = 3):
    """compress() + decompress() wall time for HOST-resident bytes:
    host split/table build, device kernels, both transfers, framing,
    CRC — what a user of the file API gets (median of ``trials``)."""
    import data_compression_tpu as dct

    cfg = dct.CodecConfig(codec="huffman", arity=2)
    blob = dct.compress(data, cfg)  # warm compiles
    out = dct.decompress(blob)
    assert out == data
    cts, dts = [], []
    for _ in range(trials):
        t0 = time.perf_counter()
        blob = dct.compress(data, cfg)
        t1 = time.perf_counter()
        out = dct.decompress(blob)
        t2 = time.perf_counter()
        cts.append(t1 - t0)
        dts.append(t2 - t1)
    assert out == data
    return (
        len(data) / float(np.median(cts)) / 1e9,
        len(data) / float(np.median(dts)) / 1e9,
    )


def bench_real_corpus() -> dict:
    """Real (non-synthetic) datapoint: the repo's own source text —
    the reference Makefile benches on its own source the same way
    (TEST_FILE_IN := n_ary_huffman.c, Makefile:15)."""
    import data_compression_tpu as dct
    from data_compression_tpu.utils.corpora import repo_source_corpus

    data = repo_source_corpus(8 * 1024 * 1024)
    cfg = dct.CodecConfig(codec="huffman", arity=2)
    blob = dct.compress(data, cfg)
    assert dct.decompress(blob) == data
    t0 = time.perf_counter()
    blob = dct.compress(data, cfg)
    dt = time.perf_counter() - t0
    return {
        "source_corpus_ratio": round(len(blob) / len(data), 4),
        "source_corpus_compress_gbps": round(len(data) / dt / 1e9, 4),
    }


def measure_copy_gbps() -> float:
    """Elementwise read+write rate of a 256 MiB int32 array on the
    device: what a memory-bound pass reaches on this card."""
    import jax
    import jax.numpy as jnp

    z = jnp.arange(64 * 1024 * 1024, dtype=jnp.int32)
    sec = median_s(jax.jit(lambda a: a * 2 + 1), z)
    return 2 * z.size * 4 / sec / 1e9


def main() -> int:
    args = [a for a in sys.argv[1:] if not a.startswith("-")]
    smoke = "--smoke" in sys.argv[1:]
    if smoke:
        import os

        os.environ["JAX_PLATFORMS"] = "cpu"
    from data_compression_tpu.utils.device_info import (
        jax_device,
        nvidia_smi_name_power,
        require_gpu,
    )

    arity = int(args[0]) if len(args) > 0 else 2
    mb = int(args[1]) if len(args) > 1 else (1 if smoke else HEADLINE_MB)
    nbytes = mb * 1024 * 1024

    if smoke:
        # CPU-only subset on a tiny corpus: exercises the full API
        # paths (XLA device route + native host codecs) and the JSON
        # contract; asserted by tests/test_bench_smoke.py.
        data = make_corpus(nbytes)
        ce, cd = bench_end_to_end(data, trials=1)
        detail = {"input_mb": mb, "smoke": True}
        detail.update(bench_serial_host(mb=1))
        detail.update(bench_real_corpus())
        result = {
            "metric": "smoke_e2e_compress_gbps",
            "value": round(ce, 4),
            "unit": "GB/s",
            "device": jax_device(),
            "detail": detail,
        }
        print(json.dumps(result))
        return 0

    device = require_gpu()
    device["nvidia_smi"] = nvidia_smi_name_power()
    data = make_corpus(nbytes)
    gbps, ratio = bench_huffman_encode(data, arity)
    detail = {"input_mb": mb, "ratio": round(ratio, 4)}

    if arity == 2:
        detail["decode_device_gbps"] = round(bench_huffman_decode(data, 2), 3)
        ce, cd = bench_e2e_device(data)
        detail["e2e_device_gbps"] = round(ce, 3)
        detail["e2e_device_decompress_gbps"] = round(cd, 3)
        small = make_corpus(SMALL_MB * 1024 * 1024, seed=1)
        for a in (3, 16):
            g, r = bench_huffman_encode(small, a)
            detail[f"huffman{a}_encode_gbps"] = round(g, 3)
            detail[f"huffman{a}_ratio"] = round(r, 4)
            detail[f"huffman{a}_decode_gbps"] = round(
                bench_huffman_decode(small, a), 3
            )
        detail.update(bench_serial_host())
        scan = make_corpus(SCAN_MB * 1024 * 1024, seed=2)
        detail["nybble_decode_scan_gbps"] = round(
            bench_nybble_scan_decode(scan), 4
        )
        ce, cd = bench_end_to_end(make_corpus(HEADLINE_MB * 1024 * 1024, seed=3))
        detail["e2e_compress_gbps"] = round(ce, 4)
        detail["e2e_decompress_gbps"] = round(cd, 4)
        detail["e2e_input_mb"] = HEADLINE_MB
        detail.update(bench_real_corpus())

    detail["device_copy_gbps"] = round(measure_copy_gbps(), 2)
    result = {
        "metric": f"huffman{arity}_encode_gbps",
        "value": round(gbps, 4),
        "unit": "GB/s",
        "device": device,
        "detail": detail,
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
