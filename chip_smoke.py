"""Smoke check of the codec on the GPU, end to end, in one process.

Runs the main paths once through the entry points a user calls, at the
sizes users run, and holds every output byte to the host reference
(the numpy / native C codecs): a lossless codec has zero tolerance.

  1. cli      ``python -m data_compression_tpu compress`` / ``decompress``
              (the same ``cli.main``, called in this process) of a
              256 MiB text file at n = 2, 3, 16, streamed as 16 MiB
              frames; ``cmp`` against the input.
  2. library  ``api.compress`` / ``api.decompress`` of one 256 MiB frame
              at n=2 and of a 64 MiB mixed corpus (one third random
              bytes: LITERAL blocks); the stream is byte-identical to
              the host reference's, which also decodes it.
  3. device   ``device_api`` on 1 GiB already in device memory (16,384
              blocks) at n = 2, 3: tables and payloads equal the host
              reference's on the same blocks; the decode kernel's
              output equals the input and the plain XLA decode
              (ops/decode_fast, in 32 MiB slices: it cannot hold 1 GiB).
  4. tests    the ``gpu``-marked tests, in this process.

``--cards 4`` runs only the sharded phase: ``compress_sharded`` /
``decompress_sharded`` on a (4, 1) mesh over 1 GiB, per-block and
shared-table, equal to the one-card ``api.compress`` stream.

Prints the card's ``nvidia-smi`` name and power limit, one line per
phase (device kind, compile and wall seconds, bytes in and out, peak
device memory), and as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
Without a GPU, or on any failure, it exits non-zero and prints no
result.

Usage: python chip_smoke.py [--cards 4]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

import bench
from data_compression_tpu import api, device_api
from data_compression_tpu.config import CodecConfig
from data_compression_tpu.utils.device_info import (
    jax_device,
    nvidia_smi_name_power,
    require_gpu,
)

MiB = 1 << 20
S = 65536
WORKDIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".smoke")

_compile_s = [0.0]


def _on_duration(event: str, duration: float, **_kw) -> None:
    if "backend_compile" in event:
        _compile_s[0] += duration


def peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")


def run_phase(name: str, fn, *args, **kwargs) -> dict:
    """Run one phase; print its line.  Failures propagate."""
    c0 = _compile_s[0]
    t0 = time.perf_counter()
    info = fn(*args, **kwargs)
    line = {
        "phase": name,
        "device_kind": jax_device()["kind"],
        "compile_s": round(_compile_s[0] - c0, 3),
        "wall_s": round(time.perf_counter() - t0, 3),
        "peak_bytes_in_use": peak_bytes(),
        **info,
    }
    print(json.dumps(line), flush=True)
    return line


def _text_table() -> np.ndarray:
    """bench.make_corpus's Zipf alphabet as a 2^16-entry lookup table
    (probabilities rounded to 1/65536), so GiB corpora take seconds."""
    alphabet = np.frombuffer(
        b" etaoinshrdlcumwfgypbvk'\"<>/=.,;:[]|()&#x1230984756-_\nqjzETAOINSHR",
        np.uint8,
    )
    p = 1.0 / np.arange(1, alphabet.size + 1) ** 1.1
    edges = np.round(np.cumsum(p / p.sum()) * 65536).astype(np.int64)
    return np.repeat(alphabet, np.diff(np.concatenate([[0], edges])))


def fast_text(nbytes: int, seed: int = 0) -> bytes:
    rng = np.random.default_rng(seed)
    return _text_table()[rng.integers(0, 65536, nbytes, dtype=np.uint16)].tobytes()


def device_text(nblocks: int, seed: int):
    """[nblocks, S] uint8 Zipf text made on the device, 64 MiB at a time."""
    import jax
    import jax.numpy as jnp

    table = jnp.asarray(_text_table())
    step = min(1024, nblocks)
    parts = []
    for k, b0 in enumerate(range(0, nblocks, step)):
        idx = jax.random.randint(
            jax.random.fold_in(jax.random.key(seed), k),
            (min(step, nblocks - b0), S), 0, 65536,
        )
        parts.append(table[idx])
    return jnp.concatenate(parts)


def phase_cli(text: bytes, arities=(2, 3, 16)) -> dict:
    from data_compression_tpu.cli import main as cli_main

    os.makedirs(WORKDIR, exist_ok=True)
    src = os.path.join(WORKDIR, "in.txt")
    with open(src, "wb") as f:
        f.write(text)
    out = {"bytes_in": len(text)}
    for n in arities:
        z = os.path.join(WORKDIR, f"n{n}.dctz")
        back = os.path.join(WORKDIR, f"n{n}.out")
        assert cli_main(["compress", "-c", "huffman", "-n", str(n), src, z]) == 0
        assert cli_main(["decompress", z, back]) == 0
        subprocess.run(["cmp", src, back], check=True)
        out[f"bytes_out_n{n}"] = os.path.getsize(z)
        os.remove(z)
        os.remove(back)
    os.remove(src)
    return out


def _library_one(data: bytes, cfg: CodecConfig) -> int:
    gpu = api.compress(data, cfg)
    host_cfg = CodecConfig(arity=cfg.arity, use_device=False)
    assert gpu == api.compress(data, host_cfg), "stream differs from host"
    assert api.decompress(gpu) == data, "device decode differs"
    assert api.decompress(gpu, host_cfg) == data, "host decode differs"
    return len(gpu)


def phase_library(text: bytes, mixed: bytes) -> dict:
    return {
        "bytes_in": len(text) + len(mixed),
        "bytes_out_text": _library_one(text, CodecConfig(arity=2)),
        "bytes_out_mixed": _library_one(mixed, CodecConfig(arity=2)),
    }


def _memory_analysis(fn, *args, **kw) -> dict:
    ma = fn.lower(*args, **kw).compile().memory_analysis()
    return {"temp": ma.temp_size_in_bytes, "args": ma.argument_size_in_bytes,
            "out": ma.output_size_in_bytes}


def phase_device(nblocks: int, arity: int, xla_slice: int = 512,
                 interpret: bool = False) -> dict:
    """device_api on nblocks device-resident blocks, checked against the
    host reference and (in slices) the plain XLA decode.  ``interpret``
    runs the decode kernel in the Pallas interpreter (CPU tests only)."""
    import jax
    import jax.numpy as jnp

    from data_compression_tpu.config import ARITY_MAX_LEN
    from data_compression_tpu.huffman import batched as hb
    from data_compression_tpu.models.huffman import HuffmanCodec
    from data_compression_tpu.ops import decode_kernel as dk
    from data_compression_tpu.ops.encode_fast import encode_blocks_compact
    from data_compression_tpu.ops.table_build import decode_tables_device

    cfg = CodecConfig(arity=arity)
    C = cfg.chunk_syms
    blocks = device_text(nblocks, seed=arity)
    raw = np.full(nblocks, S, np.int64)
    lens = jnp.full((nblocks,), S, jnp.int32)
    dc = device_api.compress_blocks_device(blocks, raw, cfg)
    jax.block_until_ready(dc.flat)
    t0 = time.perf_counter()
    dc = device_api.compress_blocks_device(blocks, raw, cfg)
    jax.block_until_ready(dc.flat)
    enc_s = time.perf_counter() - t0
    packed, bits, _, _ = device_api._tables_fn(arity, C)(blocks, lens)
    enc_mem = _memory_analysis(
        encode_blocks_compact, blocks, lens, packed, bits, arity=arity,
        chunk_syms=C, out_cap=dc.flat.shape[0],
    )

    # host reference on the same blocks
    host = np.asarray(blocks)
    hists = np.stack([np.bincount(r, minlength=256) for r in host])
    tb = hb.codes_batch(hb.capped_lengths_batch(hists, arity), arity)
    assert np.array_equal(np.asarray(dc.table_lengths), tb.table_bytes())
    total = dc.total_bytes()
    codec = HuffmanCodec(CodecConfig(arity=arity, use_device=False))
    want = b"".join(
        b"".join(ch) for ch in codec._encode_host(host, raw, tb)
    )
    assert np.asarray(dc.flat[:total]).tobytes() == want, "payload differs"

    # decode: the kernel, then the plain XLA decode slice by slice
    out = device_api.decompress_blocks_device(dc, interpret)
    assert bool(jnp.array_equal(out, blocks)), "kernel decode differs"
    t0 = time.perf_counter()
    jax.block_until_ready(device_api.decompress_blocks_device(dc, interpret))
    dec_s = time.perf_counter() - t0
    lim, bmf, syms = decode_tables_device(
        dc.table_lengths.astype(jnp.int32), arity, ARITY_MAX_LEN[arity]
    )
    nbf = dc.nb.reshape(-1)
    starts = jnp.cumsum(nbf) - nbf
    ncb = S // C
    N = nblocks * ncb
    counts = jnp.full((N,), C, jnp.int32)
    tbl = jnp.repeat(jnp.arange(nblocks, dtype=jnp.int32), ncb)
    dec_mem = _memory_analysis(
        dk.decode_chunks_kernel, dc.flat, starts, counts, tbl, lim, bmf,
        syms, arity=arity, chunk_syms=C, interpret=interpret,
    )
    q = min(N, xla_slice * ncb)
    xla_s = 0.0
    kout = out.reshape(N, C)
    for a in range(0, N, q):
        sl = slice(a, min(N, a + q))
        t0 = time.perf_counter()
        ref = dk.decode_chunks_xla(
            dc.flat, starts[sl], counts[sl], tbl[sl], lim, bmf, syms,
            arity=arity, chunk_syms=C,
        )
        jax.block_until_ready(ref)
        if a:  # the first slice compiles
            xla_s += time.perf_counter() - t0
        assert bool(jnp.array_equal(ref, kout[sl])), "kernel != decode_fast"
    nsl = max(1, -(-N // q) - 1)
    return {
        "arity": arity, "bytes_in": nblocks * S, "bytes_out": total,
        "encode_s": round(enc_s, 6), "decode_kernel_s": round(dec_s, 6),
        "decode_fast_s_per_slice": round(xla_s / nsl, 6),
        "decode_fast_slice_bytes": q * C,
        "encode_memory": enc_mem, "decode_kernel_memory": dec_mem,
    }


def phase_tests() -> dict:
    import pytest

    root = os.path.dirname(os.path.abspath(__file__))
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "-p", "no:xdist", os.path.join(root, "tests")])
    assert rc == 0, f"gpu-marked tests failed (pytest exit {rc})"
    return {"pytest_exit": int(rc)}


def phase_sharded(data: bytes, cards: int) -> dict:
    import jax

    from data_compression_tpu.parallel.mesh import make_mesh
    from data_compression_tpu.parallel.pipeline import (
        compress_sharded,
        decompress_sharded,
    )

    mesh = make_mesh(shape=(cards, 1), devices=jax.devices()[:cards])
    out = {"bytes_in": len(data)}
    for shared in (False, True):
        cfg = CodecConfig(arity=2, shared_table=shared)
        one = api.compress(data, cfg)
        sharded = compress_sharded(data, cfg, mesh)
        assert sharded == one, f"sharded stream differs (shared={shared})"
        assert decompress_sharded(sharded, mesh=mesh) == data
        out["bytes_out_shared" if shared else "bytes_out"] = len(sharded)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cards", type=int, choices=(1, 4), default=1)
    args = p.parse_args(argv)

    import jax
    import jax.monitoring

    device = require_gpu()
    if len(jax.devices()) < args.cards:
        raise SystemExit(f"--cards {args.cards}: only {len(jax.devices())} GPUs")
    jax.monitoring.register_event_duration_secs_listener(_on_duration)
    print(f"nvidia-smi: {nvidia_smi_name_power()}", flush=True)

    if args.cards == 4:
        run_phase("sharded", phase_sharded, fast_text(1024 * MiB, seed=4), 4)
    else:
        text = bench.make_corpus(256 * MiB, seed=0)
        try:
            run_phase("cli", phase_cli, text)
        finally:
            shutil.rmtree(WORKDIR, ignore_errors=True)
        from data_compression_tpu.utils.corpora import mixed_corpus

        run_phase("library", phase_library, text, mixed_corpus(64 * MiB, seed=1))
        del text
        for arity in (2, 3):
            run_phase(f"device_n{arity}", phase_device, 16384, arity)
        run_phase("tests", phase_tests)

    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
