"""Per-block byte histograms.

Reference analogue: the serial one-pass ``histogram``
(n_ary_huffman.c:461-493).  On device the whole [B, S] batch is
histogrammed at once with a flattened scatter-add (block b, byte v) ->
bin b*256+v; padding positions are dropped via an out-of-range index.
On an H100 this beat a factorized one-hot bf16 matmul at 64 and 256 MiB
and needs no [B, 16, S] one-hot operands (the matmul's 64 bytes of
temporaries per input byte would not fit 1 GiB on the card).

Unlike the reference (which asserts no NUL bytes and warns above 126,
:482-487), all 256 byte values are first-class.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


@jax.jit
def block_histograms(blocks: jnp.ndarray, lengths: jnp.ndarray) -> jnp.ndarray:
    """[B, S] uint8 + [B] valid lengths -> [B, 256] int32 counts: one
    scatter-add into bin b*256 + v (the GPU runs it with atomics)."""
    B, S = blocks.shape
    valid = jnp.arange(S)[None, :] < lengths[:, None]
    bins = jnp.arange(B, dtype=jnp.int32)[:, None] * 256 + blocks.astype(
        jnp.int32
    )
    bins = jnp.where(valid, bins, B * 256)  # padding: dropped
    h = jnp.zeros((B * 256,), jnp.int32).at[bins.reshape(-1)].add(
        1, mode="drop"
    )
    return h.reshape(B, 256)


def global_histogram(blocks: jnp.ndarray, lengths: jnp.ndarray) -> jnp.ndarray:
    """[B, S] -> [256] stream-level histogram (shared-table mode).  In
    the sharded pipeline this is psum-reduced across devices
    (parallel/pipeline.py)."""
    return block_histograms(blocks, lengths).sum(axis=0)
