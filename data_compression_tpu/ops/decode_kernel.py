"""Huffman chunk decode on the GPU: one lane per chunk (Pallas, Triton).

The wire format gives every chunk its own byte length, so chunks decode
independently.  The kernel gives each chunk one GPU thread ("lane") and
walks its symbols with the canonical limit-table compare:

  * a program owns ``TILE`` (128) consecutive chunks, four warps;
  * each step, every lane reads the bytes under its digit cursor straight
    from the flat compressed buffer (no padded copy is built), forms the
    L-digit window value W, finds the code length as the count of the
    block's scaled limits <= W (held in registers for the whole walk),
    and maps ``base_minus_first[len] + W / n^(L-len)`` to a symbol;
  * output is symbol-major ``[C, TILE]`` per program, so one step's 128
    stores are contiguous; the wrapper transposes to ``[N, C]``.

The plain XLA formulation (``ops/decode_fast.py``) runs on the CPU and is
the kernel's reference on the card.  ``decode_chunks`` is the one place
that chooses between the two.  Decode is integer work only: no matmul,
so TF32 never applies.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from data_compression_tpu.config import ARITY_DIGITS_PER_BYTE, ARITY_MAX_LEN
from data_compression_tpu.ops.decode_fast import decode_chunks_fast
from data_compression_tpu.ops.huffman_coding import max_chunk_bytes

TILE = 128  # chunks per program (one thread each)
FLAT_PAD = 4  # zero bytes after the payload: window reads past the end
KERNEL_ARITIES = (2, 3, 16)


def decode_route(platform: str) -> str:
    """Which decode runs on ``platform``: the GPU kernel on a GPU, the
    plain XLA decode elsewhere.  Never the Pallas interpreter: tests ask
    for that explicitly with ``interpret=True``."""
    return "kernel" if platform == "gpu" else "xla"


def _u32(x):
    return x.astype(jnp.uint32)


def _bitrev32(x):
    """Reverse the bits of each uint32."""
    for k, m in ((1, 0x55555555), (2, 0x33333333), (4, 0x0F0F0F0F),
                 (8, 0x00FF00FF)):
        x = ((x >> k) & m) | ((x & m) << k)
    return (x >> 16) | (x << 16)


def _nibrev32(x):
    """Reverse the order of the eight 4-bit fields of each uint32."""
    x = ((x >> 4) & 0x0F0F0F0F) | ((x & 0x0F0F0F0F) << 4)
    x = ((x >> 8) & 0x00FF00FF) | ((x & 0x00FF00FF) << 8)
    return (x >> 16) | (x << 16)


def _trits_msb_first(c):
    """Wire byte (five trits, first trit least significant) -> the same
    five trits as a base-3 value with the first trit most significant."""
    v = jnp.zeros_like(c)
    for _ in range(5):
        v = v * 3 + c % 3
        c = c // 3
    return v


def _window(flat_ref, start, off, arity: int, L: int):
    """L-digit window value (first digit most significant) at digit
    offset ``off`` of each lane's chunk.  [TILE] int32."""
    if arity == 2:
        pos = start + (off >> 3)
        x = (_u32(flat_ref[pos]) | (_u32(flat_ref[pos + 1]) << 8)
             | (_u32(flat_ref[pos + 2]) << 16))
        x = x >> _u32(off & 7)
        return (_bitrev32(x) >> (32 - L)).astype(jnp.int32)
    if arity == 16:
        pos = start + (off >> 1)
        x = (_u32(flat_ref[pos]) | (_u32(flat_ref[pos + 1]) << 8)
             | (_u32(flat_ref[pos + 2]) << 16)
             | (_u32(flat_ref[pos + 3]) << 24))
        x = x >> _u32((off & 1) * 4)
        return (_nibrev32(x) >> (32 - 4 * L)).astype(jnp.int32)
    # n = 3: five trits per byte; a 15-trit window spans <= 4 bytes.
    # Concatenate them MSB-first (3^20 < 2^32), drop the p leading
    # trits already consumed in the first byte, keep 15.
    pos = start + off // 5
    p = off % 5
    v = jnp.zeros(off.shape, jnp.uint32)
    for k in range(4):
        v = v * 243 + _trits_msb_first(_u32(flat_ref[pos + k]))
    div = jnp.where(p == 0, 243, jnp.where(p == 1, 81, jnp.where(
        p == 2, 27, jnp.where(p == 3, 9, 3)))).astype(jnp.uint32)
    return ((v // div) % jnp.uint32(3**L)).astype(jnp.int32)


def _kernel(flat_ref, start_ref, count_ref, tbl_ref, lim_ref, bmf_ref,
            sym_ref, out_ref, *, arity: int, chunk_syms: int, nflat: int):
    L = ARITY_MAX_LEN[arity]
    start = start_ref[...]
    count = count_ref[...]
    tbl = tbl_ref[...]
    lims = [lim_ref[tbl, l] for l in range(1, L)]
    # a corrupt stream can walk its cursor past its chunk; keep every
    # read inside the buffer (the CRC check rejects the block later)
    last = nflat - FLAT_PAD
    start = jnp.minimum(start, last)
    room = jnp.minimum(last - start, max_chunk_bytes(chunk_syms, arity))
    room = room * ARITY_DIGITS_PER_BYTE[arity]

    def step(s, off):
        active = s < count
        w = _window(flat_ref, start, off, arity, L)
        ln = jnp.ones_like(off)
        for lim in lims:
            ln = ln + (w >= lim).astype(jnp.int32)
        if arity == 3:
            scale = jnp.ones_like(w)
            for l in range(1, L):
                scale = jnp.where(ln == l, 3 ** (L - l), scale)
            value = w // scale
        else:
            bpd = 1 if arity == 2 else 4
            value = jax.lax.shift_right_logical(w, bpd * (L - ln))
        sidx = jnp.clip(bmf_ref[tbl, ln] + value, 0, 255)
        sym = sym_ref[tbl, sidx]
        out_ref[s, :] = jnp.where(active, sym, 0).astype(jnp.uint8)
        nxt = jnp.where(active, off + ln, off)
        # bound the cursor so start + byte offset + 3 stays in range
        return jnp.minimum(nxt, room)

    jax.lax.fori_loop(0, chunk_syms, step, jnp.zeros((TILE,), jnp.int32))


@functools.partial(
    jax.jit, static_argnames=("arity", "chunk_syms", "interpret")
)
def decode_chunks_kernel(flat, starts, counts, tbl_of_chunk, limit, bmf,
                         symbols, *, arity: int, chunk_syms: int,
                         interpret: bool = False):
    """flat: [F] uint8 chunk payloads back to back; starts/counts/
    tbl_of_chunk: [N] int32 byte offset, symbol count and table row of
    each chunk; limit/bmf: [T, L+1] int32, symbols: [T, 256] int32
    (huffman.batched.decode_rows).  -> [N, chunk_syms] uint8."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    assert arity in KERNEL_ARITIES
    C = chunk_syms
    N = starts.shape[0]
    T = max(1, -(-N // TILE))
    pad = T * TILE - N
    flat = jnp.concatenate([flat.astype(jnp.uint8),
                            jnp.zeros((FLAT_PAD,), jnp.uint8)])
    nflat = flat.shape[0]
    assert nflat < 2**31, "flat payload too large for int32 offsets"

    def lanes(x):
        return jnp.pad(x.astype(jnp.int32), (0, pad))

    lane_spec = pl.BlockSpec((TILE,), lambda i: (i,))
    whole = pl.BlockSpec(memory_space=pl.ANY)
    out = pl.pallas_call(
        functools.partial(_kernel, arity=arity, chunk_syms=C, nflat=nflat),
        grid=(T,),
        in_specs=[whole, lane_spec, lane_spec, lane_spec, whole, whole,
                  whole],
        out_specs=pl.BlockSpec((None, C, TILE), lambda i: (i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((T, C, TILE), jnp.uint8),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=TILE // 32,
                                             num_stages=1),
        interpret=interpret,
        name="huffman_decode",
    )(flat, lanes(starts), lanes(counts), lanes(tbl_of_chunk),
      limit.astype(jnp.int32), bmf.astype(jnp.int32),
      symbols.astype(jnp.int32))
    return jnp.transpose(out, (0, 2, 1)).reshape(T * TILE, C)[:N]


@functools.partial(jax.jit, static_argnames=("arity", "chunk_syms"))
def decode_chunks_xla(flat, starts, counts, tbl_of_chunk, limit, bmf,
                      symbols, *, arity: int, chunk_syms: int):
    """The plain XLA route over the same inputs: gather each chunk's
    bytes into a worst-case-width row, then ops.decode_fast."""
    mb = max_chunk_bytes(chunk_syms, arity)
    flat = jnp.concatenate([flat.astype(jnp.uint8),
                            jnp.zeros((mb,), jnp.uint8)])
    idx = starts.astype(jnp.int32)[:, None] + jnp.arange(mb, dtype=jnp.int32)
    payload = flat[jnp.clip(idx, 0, flat.shape[0] - 1)]
    return decode_chunks_fast(
        payload, counts.astype(jnp.int32), limit.astype(jnp.int32),
        bmf.astype(jnp.int32), symbols.astype(jnp.int32),
        tbl_of_chunk.astype(jnp.int32), arity=arity, chunk_syms=chunk_syms,
    )


def decode_chunks(flat, starts, counts, tbl_of_chunk, limit, bmf, symbols,
                  *, arity: int, chunk_syms: int, interpret: bool = False):
    """Decode N chunks -> [N, chunk_syms] uint8 on the route that
    ``decode_route`` picks for the default backend."""
    args = (flat, starts, counts, tbl_of_chunk, limit, bmf, symbols)
    if interpret or decode_route(jax.default_backend()) == "kernel":
        return decode_chunks_kernel(*args, arity=arity, chunk_syms=chunk_syms,
                                    interpret=interpret)
    return decode_chunks_xla(*args, arity=arity, chunk_syms=chunk_syms)
