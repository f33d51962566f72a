"""Digit-parallel canonical Huffman decode (gather-free hot path).

The scan decoder (ops/huffman_coding.decode_chunks) performs per-step
dynamic-slice gathers.  This formulation makes every expensive stage
elementwise over the whole digit stream (it is the CPU route of
ops/decode_kernel.decode_chunks and the GPU kernel's reference; its
[N, cap] int32 intermediates, ~60 bytes per input byte at n=2, keep it
to tens of MiB per call on a card):

  1. unpack payload bytes -> digits (elementwise);
  2. sliding window value W(j) for EVERY digit position j via L static
     rolls + Horner accumulation (no gather);
  3. code length l(j) at every position via broadcast compares against
     the monotone scaled-limit table, and canonical rank(j) via small
     select chains over the <=15 lengths (no gather);
  4. codeword boundary mask: a distance-to-next-boundary counter walked
     digit-by-digit — the ONLY sequential stage, a lax.scan over digit
     positions whose per-step state is one int32 per chunk lane (the
     value read each step sits at a static index, so steps are
     elementwise across lanes — no gather);
  5. compaction of ranks at boundary positions into the C output slots:
     every digit position becomes a 0-bit or 8-bit item and the
     encoder's scatter-free merge tree (ops/encode_fast._multiword_shl)
     concatenates them;
  6. rank -> symbol via a select chain over the canonical symbol list.

Bit-exact with decode_chunks (tests/test_decode_fast.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from data_compression_tpu.config import ARITY_DIGITS_PER_BYTE, ARITY_MAX_LEN
from data_compression_tpu.ops.encode_fast import _multiword_shl
from data_compression_tpu.ops.huffman_coding import _cap_digits


@functools.partial(jax.jit, static_argnames=("arity", "chunk_syms"))
def decode_chunks_fast(
    payload: jnp.ndarray,  # [N, max_bytes] uint8
    counts: jnp.ndarray,  # [N]
    limit_scaled: jnp.ndarray,  # [T, L+1] int32 monotone
    base_minus_first: jnp.ndarray,  # [T, L+1] int32
    symbols_tab: jnp.ndarray,  # [T, S] int32
    tbl_of_chunk: jnp.ndarray,  # [N]
    *,
    arity: int,
    chunk_syms: int,
):
    N = payload.shape[0]
    C = chunk_syms
    L = ARITY_MAX_LEN[arity]
    D = ARITY_DIGITS_PER_BYTE[arity]
    cap = _cap_digits(C, arity)

    # 1. unpack digits, pad with L zeros for the window reads
    b = payload.astype(jnp.int32)
    dpow = jnp.asarray(arity ** np.arange(D), jnp.int32)
    digits = ((b[:, :, None] // dpow[None, None, :]) % arity).reshape(N, cap)
    digits = jnp.concatenate([digits, jnp.zeros((N, L), jnp.int32)], axis=1)

    # 2. window values W(j) for all j: Horner over L static shifts
    W = jnp.zeros((N, cap), jnp.int32)
    for k in range(L):
        W = W * arity + jax.lax.dynamic_slice_in_dim(digits, k, cap, axis=1)

    # 3. l(j) and rank(j), elementwise
    lim = limit_scaled[tbl_of_chunk]  # [N, L+1]  (small gather over T rows)
    bmf = base_minus_first[tbl_of_chunk]
    ln = jnp.ones((N, cap), jnp.int32)
    for l in range(1, L):
        ln = ln + (W >= lim[:, l][:, None]).astype(jnp.int32)
    pow_n = arity ** np.arange(L + 1)
    scale = jnp.zeros((N, cap), jnp.int32)
    bmf_j = jnp.zeros((N, cap), jnp.int32)
    for l in range(1, L + 1):
        is_l = ln == l
        scale = jnp.where(is_l, jnp.int32(pow_n[L - l]), scale)
        bmf_j = jnp.where(is_l, bmf[:, l][:, None], bmf_j)
    rank = bmf_j + W // jnp.maximum(scale, 1)

    # 4. boundary mask: dist-to-next-boundary walk over digit positions
    lnT = ln.T  # [cap, N] so scan steps read a static row
    def step(dist, ln_row):
        boundary = dist == 0
        dist = jnp.where(boundary, ln_row - 1, dist - 1)
        return dist, boundary
    _, maskT = jax.lax.scan(step, jnp.zeros((N,), jnp.int32), lnT)
    mask = maskT.T  # [N, cap]

    # Only the first `counts` boundaries are real symbols; the stream
    # may be followed by padding digits. Boundary index:
    bidx = jnp.cumsum(mask.astype(jnp.int32), axis=1) - mask.astype(jnp.int32)
    mask = mask & (bidx < counts[:, None])

    # 5. compact ranks at boundaries into C bytes via the merge tree.
    # Pad item count to a power of two.
    P = 1
    while P < cap:
        P *= 2
    padn = P - cap
    items = jnp.where(mask, rank, 0).astype(jnp.uint32)
    lens = jnp.where(mask, 8, 0).astype(jnp.int32)
    if padn:
        items = jnp.pad(items, [(0, 0), (0, padn)])
        lens = jnp.pad(lens, [(0, 0), (0, padn)])
    out_bits_cap = C * 8
    Wf = out_bits_cap // 32
    words = items[..., None]
    lw = lens
    p, w = P, 1
    level = 0
    while p > 1:
        level += 1
        need = min((1 << level) * 8, out_bits_cap)
        W2 = min(-(-need // 32), Wf)
        a, bb = words[:, 0::2], words[:, 1::2]
        la, lb = lw[:, 0::2], lw[:, 1::2]
        if W2 > w:
            padw = [(0, 0), (0, 0), (0, W2 - w)]
            a = jnp.pad(a, padw)
            bb = jnp.pad(bb, padw)
        words = a | _multiword_shl(bb, la)
        lw = la + lb
        p //= 2
        w = W2
    buf = words[:, 0]  # [N, Wf] u32: C rank bytes
    shifts = (8 * jnp.arange(4, dtype=jnp.uint32))[None, None, :]
    ranks8 = ((buf[:, :, None] >> shifts) & jnp.uint32(0xFF)).astype(jnp.int32)
    ranks8 = ranks8.reshape(N, Wf * 4)[:, :C]

    # 6. rank -> symbol select chain over the canonical symbol list
    syms_t = symbols_tab[tbl_of_chunk]  # [N, S]
    S = syms_t.shape[1]
    out = jnp.zeros((N, C), jnp.int32)
    for r in range(S):
        out = jnp.where(ranks8 == r, syms_t[:, r][:, None], out)
    return out.astype(jnp.uint8)
