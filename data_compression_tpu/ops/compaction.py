"""Device-side payload compaction: ragged chunk payloads -> one flat
contiguous buffer.

The encoder (ops/encode_fast.py) emits worst-case-width rows ([N, MB]
with only ``nbytes[i]`` valid per row, ~1.9x the input at n=2).  This
op concatenates the valid prefixes on the device, inside the encode
jit, so the host downloads exactly the compressed bytes and assembles
frames from one contiguous array.

Formulation (static shapes only): scatter one marker per chunk at its
output start offset, a cumsum turns the markers into ``chunk_of_byte``
(the run-length expansion trick of ops/huffman_coding.encode_chunks),
and each output byte is then one 32-bit word gather + shift.
``out_cap`` is a static bucket >= the true total; the host slices the
result to the exact total.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

BUCKET = 4 * 1024 * 1024  # out_cap granularity: bounds recompiles


def round_cap(total: int) -> int:
    """Smallest bucket multiple >= total (>= 1 bucket)."""
    return max(BUCKET, -(-total // BUCKET) * BUCKET)


@functools.partial(jax.jit, static_argnames=("out_cap",))
def compact_rows(rows: jnp.ndarray, nbytes: jnp.ndarray, out_cap: int):
    """rows: [N, MB] uint8, nbytes: [N] int — returns
    [out_cap] uint8 holding rows[0, :nbytes[0]] ++ rows[1, :nbytes[1]]
    ++ ...; bytes past the true total are undefined."""
    if rows.shape[1] % 4:
        rows = jnp.pad(rows, [(0, 0), (0, -rows.shape[1] % 4)])
    N, MB = rows.shape
    nbytes = nbytes.astype(jnp.int32)
    starts = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), jnp.cumsum(nbytes)]
    )  # [N+1]
    # chunk_of_byte via scatter-add markers + cumsum; zero-length chunks
    # bump the same position as their successor and never own bytes.
    markers = jnp.zeros((out_cap,), jnp.int32).at[starts[:-1]].add(
        1, mode="drop"
    )
    cid = jnp.cumsum(markers) - 1  # [out_cap]
    cid = jnp.clip(cid, 0, N - 1)
    k = jnp.clip(jnp.arange(out_cap, dtype=jnp.int32) - starts[cid], 0, MB - 1)
    # (row, word) gather: N * MB can pass 2^31 at GiB scale, so no
    # flat int32 byte index
    words = jax.lax.bitcast_convert_type(
        rows.reshape(N, MB // 4, 4), jnp.uint32
    )
    w = words[cid, k >> 2]
    return (w >> (8 * (k & 3).astype(jnp.uint32))).astype(jnp.uint8)
