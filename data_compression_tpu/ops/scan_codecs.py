"""Serial-state codecs as vmapped lax.scan lanes — one block per lane.

The MTF/LZW schemes are inherently sequential *within* a block (every
output byte depends on the mutable context table updated by the
previous byte — SURVEY.md §3.3), so the device strategy is parallelism
*across* blocks: a ``jax.lax.scan`` carries the 16x8 context table per
lane and ``jax.vmap`` runs thousands of lanes at once.  All shapes are
static; emission counts vary per step, so streams are assembled with an
exclusive-cumsum scatter into a padded buffer and compacted on host.

Semantics are bit-exact with models/nybble.py (itself bit-exact with
nybble_compression.c) — enforced by tests/test_nybble.py which
cross-checks the two paths byte-for-byte.
"""

from __future__ import annotations

import functools
from typing import List

import jax
import jax.numpy as jnp
import numpy as np

from data_compression_tpu.models import nybble as nyb_host
from data_compression_tpu.models.small import MAX_WORD

_SEED = jnp.asarray(np.frombuffer(nyb_host.SEED_ROW, np.uint8).astype(np.int32))


def _init_table():
    return jnp.tile(_SEED[None, :], (16, 1))


def _mtf_update(table, ctx, byte):
    """Vectorized update_context (nybble_compression.c:665-687)."""
    row = jax.lax.dynamic_slice(table, (ctx, 0), (1, 8))[0]
    eq = row == byte
    hit = jnp.any(eq)
    pos = jnp.where(hit, jnp.argmax(eq), 7)
    j = jnp.arange(8)
    shifted = jnp.where(j == 0, byte, row[jnp.maximum(j - 1, 0)])
    new_row = jnp.where(j <= pos, shifted, row)
    return jax.lax.dynamic_update_slice(table, new_row[None, :], (ctx, 0))


def _encode_lane(src, length):
    """Encode one block lane. src: [S] int32, length: scalar int32.

    Returns (counts [S-1+1], b1 [S], b2 [S]) where step i in [0, S-1)
    handles src[i+1] and the last slot is the odd-nybble flush.
    """
    S = src.shape[0]

    def step(carry, i):
        table, pending = carry
        p = src[i - 1]
        s = src[i]
        active = i < length
        ctx = (p >> 3) & 15
        row = jax.lax.dynamic_slice(table, (ctx, 0), (1, 8))[0]
        eq = row == s
        hit = jnp.any(eq)
        pos = jnp.argmax(eq)
        nybv = 8 | pos
        has_pending = pending >= 0

        # hit & no pending  -> emit 0, pending' = nyb
        # hit & pending     -> emit 1: (pending<<4)|nyb
        # miss & no pending -> emit 1: s (aligned literal)
        # miss & pending    -> emit 2: p, s (re-expand previous)
        count = jnp.where(
            hit,
            jnp.where(has_pending, 1, 0),
            jnp.where(has_pending, 2, 1),
        )
        b1 = jnp.where(
            hit,
            (pending << 4) | nybv,
            jnp.where(has_pending, p, s),
        )
        b2 = s
        new_pending = jnp.where(hit & ~has_pending, nybv, -1)

        new_table = _mtf_update(table, ctx, s)
        table = jnp.where(active, new_table, table)
        pending = jnp.where(active, new_pending, pending)
        count = jnp.where(active, count, 0)
        return (table, pending), (count, b1.astype(jnp.int32), b2)

    (table, pending), (counts, b1, b2) = jax.lax.scan(
        step, (_init_table(), jnp.int32(-1)), jnp.arange(1, S)
    )
    # Trailing odd-nybble flush (compress_bytestring :1000-1009).
    flush_count = jnp.where(pending >= 0, 1, 0)
    flush_byte = src[jnp.maximum(length - 1, 0)]
    counts = jnp.concatenate([counts, flush_count[None]])
    b1 = jnp.concatenate([b1, flush_byte[None]])
    b2 = jnp.concatenate([b2, jnp.zeros((1,), jnp.int32)])

    # Assemble: header [0xAF, src[0]] then scattered emissions.
    out = jnp.zeros((S + 4,), jnp.int32)
    out = out.at[0].set(nyb_host.NYBBLES_TYPE)
    out = out.at[1].set(src[0])
    start = 2 + jnp.cumsum(counts) - counts  # exclusive cumsum
    trash = S + 3
    idx1 = jnp.where(counts >= 1, start, trash)
    idx2 = jnp.where(counts >= 2, start + 1, trash)
    out = out.at[idx1].set(b1, mode="drop")
    out = out.at[idx2].set(b2, mode="drop")
    total = 2 + jnp.sum(counts)
    return out.astype(jnp.uint8), total


def _decode_lane(payload, raw_len, S):
    """Decode one lane. payload: [P] int32 (type byte stripped by
    caller: payload[0] is the verbatim first plaintext byte).  S is the
    static maximum output length."""
    P = payload.shape[0]
    first = payload[0]

    def step(carry, i):
        table, j, prev = carry
        active = i < raw_len - 1
        b = payload[jnp.minimum(1 + (j >> 1), P - 1)]
        nybv = jnp.where((j & 1) == 0, (b >> 4) & 0xF, b & 0xF)
        j2 = j + 1
        b2 = payload[jnp.minimum(1 + (j2 >> 1), P - 1)]
        nxt = jnp.where((j2 & 1) == 0, (b2 >> 4) & 0xF, b2 & 0xF)
        compressed = (nybv & 0x8) != 0
        ctx = (prev >> 3) & 15
        row = jax.lax.dynamic_slice(table, (ctx, 0), (1, 8))[0]
        o = jnp.where(compressed, row[nybv & 0x7], ((nybv & 0x7) << 4) | nxt)
        used = jnp.where(compressed, 1, 2)
        new_table = _mtf_update(table, ctx, o)
        table = jnp.where(active, new_table, table)
        j = jnp.where(active, j + used, j)
        prev = jnp.where(active, o, prev)
        return (table, j, prev), jnp.where(active, o, 0)

    (_, _, _), outs = jax.lax.scan(
        step,
        (_init_table(), jnp.int32(0), first),
        jnp.arange(S - 1),
    )
    return jnp.concatenate([first[None], outs]).astype(jnp.uint8)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@jax.jit
def _encode_batch(src, lengths):
    return jax.vmap(_encode_lane)(src.astype(jnp.int32), lengths)


@functools.partial(jax.jit, static_argnames=("S",))
def _decode_batch(payloads, raw_lens, S):
    return jax.vmap(lambda p, r: _decode_lane(p, r, S))(
        payloads.astype(jnp.int32), raw_lens
    )


def nybble_encode_blocks(blocks: np.ndarray, lengths: np.ndarray) -> List[bytes]:
    """Device-parallel encode of [B, S] blocks -> list of payload bytes.

    Blocks containing bytes >= 0x80 are returned raw (the framing layer
    turns them into LITERAL blocks), matching the host path.
    """
    blocks = np.asarray(blocks, np.uint8)
    lengths = np.asarray(lengths, np.int64)
    out, totals = _encode_batch(jnp.asarray(blocks), jnp.asarray(lengths, jnp.int32))
    out = np.asarray(out)
    totals = np.asarray(totals)
    payloads = []
    for i in range(blocks.shape[0]):
        n = int(lengths[i])
        if n and blocks[i, :n].max(initial=0) >= 0x80:
            payloads.append(blocks[i, :n].tobytes())
        elif n == 0:
            payloads.append(bytes([nyb_host.NYBBLES_TYPE]))
        else:
            payloads.append(out[i, : int(totals[i])].tobytes())
    return payloads


WMAX = 256  # longest LZW word (encoder caps matches below this)


def _small_byte_decode_lane(payload, plen, raw_len, S):
    """One small_byte block as a scan over compressed indexes.

    Span-dictionary decode (models/small.py): every emitted word is a
    copy of an earlier output span (or a literal / default 2-byte
    entry), so each step is one dynamic slice + one dynamic update —
    LZ77-style — with the dictionary as fixed-shape carry arrays.
    """
    P = payload.shape[0]

    def step(carry, i):
        out, out_len, starts, lengths, nwi, prev_ctx, prev_pos, prev_len = carry
        active = (i + 2 < plen) & (out_len < raw_len)
        idx = payload[jnp.minimum(i + 2, P - 1)]
        ctx = out[jnp.maximum(out_len - 1, 0)] & 31

        s = jnp.maximum(idx - 0x80, 0)
        st = starts[ctx, s]
        ln = lengths[ctx, s]
        is_lit = idx < 0x80
        is_default = (~is_lit) & (st < 0)
        # word window: literal -> [idx, ...], default -> [' ', s|'x'],
        # span -> out[st : st+WMAX]
        win = jax.lax.dynamic_slice(out, (jnp.maximum(st, 0),), (WMAX,))
        k = jnp.arange(WMAX)
        default_b1 = jnp.where(s == 0, ord("x"), s)
        win = jnp.where(
            is_lit,
            jnp.where(k == 0, idx, 0),
            jnp.where(
                is_default,
                jnp.where(k == 0, ord(" "), jnp.where(k == 1, default_b1, 0)),
                win,
            ),
        )
        wl = jnp.where(is_lit, 1, jnp.where(is_default, 2, ln))

        # write the word (unmasked WMAX bytes; tail positions are
        # future slots that later steps overwrite)
        new_out = jax.lax.dynamic_update_slice(out, win, (out_len,))
        out = jnp.where(active, new_out, out)

        # lock-step insert: span (prev_pos, prev_len + 1) in prev_ctx
        tochange = nwi[prev_ctx]
        starts = jnp.where(
            active, starts.at[prev_ctx, tochange].set(prev_pos), starts
        )
        lengths = jnp.where(
            active, lengths.at[prev_ctx, tochange].set(prev_len + 1), lengths
        )
        nwi = jnp.where(
            active, nwi.at[prev_ctx].set((tochange + 1) % 0x7F), nwi
        )

        prev_ctx = jnp.where(active, ctx, prev_ctx)
        prev_pos = jnp.where(active, out_len, prev_pos)
        prev_len = jnp.where(active, wl, prev_len)
        out_len = jnp.where(active, out_len + wl, out_len)
        return (out, out_len, starts, lengths, nwi, prev_ctx, prev_pos, prev_len), 0

    out0 = jnp.zeros((S + WMAX,), jnp.int32)
    out0 = out0.at[0].set(payload[1])
    carry0 = (
        out0,
        jnp.int32(1),
        jnp.full((32, 0x7F), -1, jnp.int32),
        jnp.full((32, 0x7F), 2, jnp.int32),
        jnp.zeros((32,), jnp.int32),
        jnp.int32(ord(" ") & 31),
        jnp.int32(0),
        jnp.int32(1),
    )
    (out, out_len, *_), _ = jax.lax.scan(step, carry0, jnp.arange(P - 2))
    return out[:S].astype(jnp.uint8)


@functools.partial(jax.jit, static_argnames=("S",))
def _small_byte_decode_batch(payloads, plens, raw_lens, S):
    return jax.vmap(lambda p, pl, r: _small_byte_decode_lane(p, pl, r, S))(
        payloads.astype(jnp.int32), plens, raw_lens
    )


def small_byte_decode_blocks(payloads: List[bytes], raw_lens: List[int]) -> List[bytes]:
    """Device-parallel span-LZW decode, one lane per block."""
    if not payloads:
        return []
    B = len(payloads)
    P = max(max(len(p) for p in payloads), 3)
    arr = np.zeros((B, P), np.uint8)
    plens = np.zeros(B, np.int32)
    for i, p in enumerate(payloads):
        if len(p) == 0 or p[0] != 8:  # EIGHT_BIT_PRUNED
            raise ValueError(f"block {i}: bad small_byte stream type byte")
        arr[i, : len(p)] = np.frombuffer(p, np.uint8)
        plens[i] = len(p)
    rl = np.asarray(raw_lens, np.int32)
    S = max(_round_up(int(rl.max(initial=1)), 4096), WMAX)
    outs = np.asarray(
        _small_byte_decode_batch(
            jnp.asarray(arr), jnp.asarray(plens), jnp.asarray(rl), S
        )
    )
    return [outs[i, : int(rl[i])].tobytes() for i in range(B)]


def _small_byte_encode_lane(src, length):
    """Greedy longest-match scheme-A encoder as one scan lane —
    the device mirror of models.small.small_byte_encode_host (same
    frozen-span dictionary, generation counters, banned-slot rule).

    One scan step consumes exactly one source byte: it either extends
    the in-flight match (no emission) or emits the finished word's
    index and starts a new match at this byte.  Emissions scatter by
    exclusive cumsum, like the nybble lane.  src: [S] int32 (7-bit);
    returns (out [S+4] uint8 incl. the type byte + verbatim first
    byte, total i32)."""
    S = src.shape[0]
    NS = 0x7F  # dict slots per context

    def step(carry, i):
        (starts, lens_, gen, prefix, pgen, letter, nwi,
         ctx_c, banned, index, mstart, mlen,
         pctx, pidx, ppos, plen) = carry
        active = i < length
        b = src[jnp.minimum(i, S - 1)]

        # try to extend the in-flight match with byte b
        slot = index - 0x80  # <0 for literal prefixes
        gref = gen[ctx_c, jnp.clip(slot, 0, NS - 1)]
        ok = (prefix[ctx_c] == index) & (letter[ctx_c] == b)
        ok = ok & jnp.where(slot >= 0, pgen[ctx_c] == gref, True)
        ok = ok & (jnp.arange(NS) != banned)
        hit = jnp.any(ok)
        w = jnp.argmax(ok)
        can_extend = hit & (mlen < MAX_WORD - 1)

        # a miss emits the finished word and does the deferred insert:
        # new dict word = previous word + first byte of this word
        emit = active & ~can_extend
        tochange = nwi[pctx]
        first_b = src[jnp.minimum(mstart, S - 1)]
        starts = jnp.where(emit, starts.at[pctx, tochange].set(ppos), starts)
        lens_ = jnp.where(emit, lens_.at[pctx, tochange].set(plen + 1), lens_)
        gen = jnp.where(emit, gen.at[pctx, tochange].add(1), gen)
        prefix = jnp.where(emit, prefix.at[pctx, tochange].set(pidx), prefix)
        pslot = pidx - 0x80
        pg = jnp.where(
            pslot >= 0, gen[pctx, jnp.clip(pslot, 0, NS - 1)], 0
        )
        pgen = jnp.where(emit, pgen.at[pctx, tochange].set(pg), pgen)
        letter = jnp.where(emit, letter.at[pctx, tochange].set(first_b), letter)
        nwi = jnp.where(emit, nwi.at[pctx].set((tochange + 1) % NS), nwi)

        out_byte = index
        # previous-word bookkeeping rolls forward on emission
        pctx = jnp.where(emit, ctx_c, pctx)
        pidx = jnp.where(emit, index, pidx)
        ppos = jnp.where(emit, mstart, ppos)
        plen = jnp.where(emit, mlen, plen)

        # start a new match at byte b (on emission) or extend
        new_ctx = src[jnp.minimum(i - 1, S - 1)] & 31
        new_banned = jnp.where(
            new_ctx == pctx, nwi[pctx], -1
        )
        ctx_c = jnp.where(emit, new_ctx, ctx_c)
        banned = jnp.where(emit, new_banned, banned)
        index = jnp.where(
            emit, b, jnp.where(can_extend & active, 0x80 + w, index)
        )
        mstart = jnp.where(emit, i, mstart)
        mlen = jnp.where(
            emit, 1, jnp.where(can_extend & active, mlen + 1, mlen)
        )
        count = jnp.where(emit, 1, 0)
        return (
            (starts, lens_, gen, prefix, pgen, letter, nwi,
             ctx_c, banned, index, mstart, mlen,
             pctx, pidx, ppos, plen),
            (count, out_byte),
        )

    letter0 = jnp.tile(jnp.arange(NS, dtype=jnp.int32)[None, :], (32, 1))
    letter0 = letter0.at[:, 0].set(ord("x"))
    # the first word starts at position 1 (src[0] rides verbatim)
    carry0 = (
        jnp.full((32, NS), -1, jnp.int32),   # starts
        jnp.full((32, NS), 2, jnp.int32),    # lengths
        jnp.zeros((32, NS), jnp.int32),      # gen
        jnp.full((32, NS), ord(" "), jnp.int32),  # prefix
        jnp.zeros((32, NS), jnp.int32),      # prefix_gen
        letter0,                              # letter
        jnp.zeros((32,), jnp.int32),         # nwi
        src[0] & 31,                          # ctx of first word
        jnp.int32(-1),                        # banned (pctx=ctx(' ')=0
        #   differs from ctx unless src[0]&31==0; fixed below)
        src[jnp.minimum(1, S - 1)],           # index (first byte)
        jnp.int32(1),                         # mstart
        jnp.int32(1),                         # mlen
        jnp.int32(ord(" ") & 31),             # pctx
        src[0],                               # pidx
        jnp.int32(0),                         # ppos
        jnp.int32(1),                         # plen
    )
    # banned for the first word: host rule vs prev_context = ctx(' ')
    carry0 = carry0[:8] + (
        jnp.where((src[0] & 31) == (ord(" ") & 31), 0, -1).astype(jnp.int32),
    ) + carry0[9:]
    (carry, (counts, bts)) = jax.lax.scan(
        step, carry0, jnp.arange(2, S + 1)
    )
    # flush the in-flight word (positions consumed: 1..length-1)
    index_f = carry[9]
    have_tail = length > 1
    counts = jnp.concatenate([counts, jnp.where(have_tail, 1, 0)[None]])
    bts = jnp.concatenate([bts, index_f[None]])

    out = jnp.zeros((S + 4,), jnp.int32)
    out = out.at[0].set(8)  # EIGHT_BIT_PRUNED
    out = out.at[1].set(src[0])
    start = 2 + jnp.cumsum(counts) - counts
    trash = S + 3
    idx1 = jnp.where(counts >= 1, start, trash)
    out = out.at[idx1].set(bts, mode="drop")
    total = jnp.where(length > 0, 2 + jnp.sum(counts), 1)
    return out.astype(jnp.uint8), total


@jax.jit
def _small_byte_encode_batch(src, lengths):
    return jax.vmap(_small_byte_encode_lane)(
        src.astype(jnp.int32), lengths
    )


def small_byte_encode_blocks(blocks: np.ndarray, lengths: np.ndarray) -> List[bytes]:
    """Device-parallel scheme-A encode, one scan lane per block —
    bit-exact with models.small.small_byte_encode_host (differential-
    tested).  Blocks with bytes >= 0x80 return raw (framing turns them
    into LITERAL blocks), matching the host path's precondition."""
    blocks = np.asarray(blocks, np.uint8)
    lengths = np.asarray(lengths, np.int64)
    out, totals = _small_byte_encode_batch(
        jnp.asarray(blocks), jnp.asarray(lengths, jnp.int32)
    )
    out = np.asarray(out)
    totals = np.asarray(totals)
    payloads = []
    for i in range(blocks.shape[0]):
        n = int(lengths[i])
        if n and blocks[i, :n].max(initial=0) >= 0x80:
            payloads.append(blocks[i, :n].tobytes())
        elif n == 0:
            payloads.append(bytes([8]))
        else:
            payloads.append(out[i, : int(totals[i])].tobytes())
    return payloads


W2MAX = 512  # longest nybble-LZW word in NYBBLES (2 * MAX_WORD)


def _small_nybble_encode_lane(src, length):
    """Greedy longest-match scheme-B encoder as one scan lane — the
    nybble-coordinate mirror of ``_small_byte_encode_lane``
    (models.small.small_nybble_encode_host semantics: literal indexes
    0x10-0x1F, spans over the full decoded nybble stream, slots
    0x80..0xFF wrapping to 0x80, the -1 first-word sentinel).  One
    scan step consumes one source NYBBLE.  src: [S] int32 bytes;
    returns (out [2*S+4] uint8, total i32)."""
    S = src.shape[0]
    NS = 256

    def nyb_at(i):
        b = src[jnp.minimum(i >> 1, S - 1)]
        return jnp.where((i & 1) == 0, b & 0xF, (b >> 4) & 0xF)

    lit_slots = (jnp.arange(NS) | 0xF) == 0x1F

    def step(carry, i):
        (starts, lens_, gen, prefix, pgen, letter, nwi,
         ctx_c, banned, index, mstart, mlen,
         pctx, pidx, ppos, plen) = carry
        active = i < 2 * length
        nyb = nyb_at(i)

        # extend the in-flight match with nybble `nyb`?
        is_lit_idx = (index | 0xF) == 0x1F
        st_idx = starts[ctx_c, jnp.clip(index, 0, NS - 1)]
        g_idx = gen[ctx_c, jnp.clip(index, 0, NS - 1)]
        need_gen = jnp.where(st_idx >= 0, g_idx, 0)
        ok = (prefix[ctx_c] == index) & (letter[ctx_c] == nyb)
        ok = ok & jnp.where(is_lit_idx, True, pgen[ctx_c] == need_gen)
        ok = ok & ~lit_slots & (jnp.arange(NS) != banned)
        hit = jnp.any(ok)
        w = jnp.argmax(ok)
        can_extend = hit & (mlen < 2 * MAX_WORD - 1)

        emit = active & ~can_extend
        tochange = nwi[pctx]
        first_n = nyb_at(mstart)
        starts = jnp.where(emit, starts.at[pctx, tochange].set(ppos), starts)
        lens_ = jnp.where(emit, lens_.at[pctx, tochange].set(plen + 1), lens_)
        gen = jnp.where(emit, gen.at[pctx, tochange].add(1), gen)
        prefix = jnp.where(emit, prefix.at[pctx, tochange].set(pidx), prefix)
        p_ok = (
            (pidx >= 0)
            & ((pidx | 0xF) != 0x1F)
            & (starts[pctx, jnp.clip(pidx, 0, NS - 1)] >= 0)
        )
        pg = jnp.where(p_ok, gen[pctx, jnp.clip(pidx, 0, NS - 1)], 0)
        pgen = jnp.where(emit, pgen.at[pctx, tochange].set(pg), pgen)
        letter = jnp.where(emit, letter.at[pctx, tochange].set(first_n), letter)
        nxt = jnp.where(tochange + 1 >= 0x100, 0x80, tochange + 1)
        nwi = jnp.where(emit, nwi.at[pctx].set(nxt), nwi)

        out_byte = index
        pctx = jnp.where(emit, ctx_c, pctx)
        pidx = jnp.where(emit, index, pidx)
        ppos = jnp.where(emit, mstart, ppos)
        plen = jnp.where(emit, mlen, plen)

        # new word starts at nybble i: context = last complete output
        # byte (output == input), i.e. src[i//2 - 1]
        new_ctx = src[jnp.minimum(jnp.maximum((i >> 1) - 1, 0), S - 1)] & 31
        new_banned = jnp.where(new_ctx == pctx, nwi[pctx], -1)
        ctx_c = jnp.where(emit, new_ctx, ctx_c)
        banned = jnp.where(emit, new_banned, banned)
        index = jnp.where(
            emit, nyb | 0x10, jnp.where(can_extend & active, w, index)
        )
        mstart = jnp.where(emit, i, mstart)
        mlen = jnp.where(
            emit, 1, jnp.where(can_extend & active, mlen + 1, mlen)
        )
        count = jnp.where(emit, 1, 0)
        return (
            (starts, lens_, gen, prefix, pgen, letter, nwi,
             ctx_c, banned, index, mstart, mlen,
             pctx, pidx, ppos, plen),
            (count, out_byte),
        )

    idx = jnp.arange(NS, dtype=jnp.int32)
    carry0 = (
        jnp.full((32, NS), -1, jnp.int32),               # starts
        jnp.zeros((32, NS), jnp.int32),                  # lengths
        jnp.zeros((32, NS), jnp.int32),                  # gen
        jnp.tile(((idx & 0x0F) | 0x10)[None, :], (32, 1)),  # prefix
        jnp.zeros((32, NS), jnp.int32),                  # prefix_gen
        jnp.tile(((idx >> 4) & 0x0F)[None, :], (32, 1)),  # letter
        jnp.full((32,), 0x80, jnp.int32),                # nwi
        src[0] & 31,                                     # ctx first word
        jnp.where((src[0] & 31) == (ord(" ") & 31), jnp.int32(0x80),
                  jnp.int32(-1)),                        # banned
        nyb_at(jnp.int32(2)) | 0x10,                     # index
        jnp.int32(2),                                    # mstart
        jnp.int32(1),                                    # mlen
        jnp.int32(ord(" ") & 31),                        # pctx
        jnp.int32(-1),                                   # pidx sentinel
        jnp.int32(0),                                    # ppos
        jnp.int32(2),                                    # plen
    )
    (carry, (counts, bts)) = jax.lax.scan(
        step, carry0, jnp.arange(3, 2 * S + 1)
    )
    index_f = carry[9]
    have_tail = length > 1
    counts = jnp.concatenate([counts, jnp.where(have_tail, 1, 0)[None]])
    bts = jnp.concatenate([bts, index_f[None]])

    out = jnp.zeros((2 * S + 4,), jnp.int32)
    out = out.at[0].set(8)  # EIGHT_BIT_PRUNED
    out = out.at[1].set(src[0])
    start = 2 + jnp.cumsum(counts) - counts
    trash = 2 * S + 3
    idx1 = jnp.where(counts >= 1, start, trash)
    out = out.at[idx1].set(bts, mode="drop")
    total = jnp.where(length > 0, 2 + jnp.sum(counts), 1)
    return out.astype(jnp.uint8), total


@jax.jit
def _small_nybble_encode_batch(src, lengths):
    return jax.vmap(_small_nybble_encode_lane)(
        src.astype(jnp.int32), lengths
    )


def small_nybble_encode_blocks(
    blocks: np.ndarray, lengths: np.ndarray
) -> List[bytes]:
    """Device-parallel scheme-B encode, one scan lane per block —
    bit-exact with models.small.small_nybble_encode_host."""
    blocks = np.asarray(blocks, np.uint8)
    lengths = np.asarray(lengths, np.int64)
    out, totals = _small_nybble_encode_batch(
        jnp.asarray(blocks), jnp.asarray(lengths, jnp.int32)
    )
    out = np.asarray(out)
    totals = np.asarray(totals)
    payloads = []
    for i in range(blocks.shape[0]):
        n = int(lengths[i])
        if n == 0:
            payloads.append(bytes([8]))
        else:
            payloads.append(out[i, : int(totals[i])].tobytes())
    return payloads


def _small_nybble_decode_lane(payload, plen, raw_len, S):
    """One small_nybble block as a scan over compressed indexes.

    The nybble-coordinate mirror of ``_small_byte_decode_lane``: the
    dictionary spans index the decoded NYBBLE stream (low nybble first,
    small_compression.c:795-801), literal nybbles live at indexes
    0x10-0x1F (:803-805), every other index defaults to its own two
    nybbles (initialize_table :783-836), and slots allocate 0x80..0xFF
    wrapping to 0x80 (increment_table_index :1330-1384).  Bit-exact
    with models.small.small_nybble_decode_host (differential-tested).
    ``S``: static max output BYTES; the carry tracks 2*S nybbles.
    """
    P = payload.shape[0]

    def step(carry, i):
        nybs, nlen, starts, lengths, nwi, prev_ctx, prev_pos, prev_len = carry
        active = (i + 2 < plen) & (nlen < 2 * raw_len)
        idx = payload[jnp.minimum(i + 2, P - 1)]
        done = nlen >> 1  # complete output bytes so far
        last_byte = (
            nybs[jnp.maximum(2 * done - 2, 0)]
            | (nybs[jnp.maximum(2 * done - 1, 0)] << 4)
        )
        ctx = last_byte & 31

        st = starts[ctx, idx]
        ln = lengths[ctx, idx]
        is_lit = (idx | 0xF) == 0x1F  # literal nybble index
        is_default = (~is_lit) & (st < 0)
        win = jax.lax.dynamic_slice(nybs, (jnp.maximum(st, 0),), (W2MAX,))
        k = jnp.arange(W2MAX)
        win = jnp.where(
            is_lit,
            jnp.where(k == 0, idx & 0xF, 0),
            jnp.where(
                is_default,
                jnp.where(
                    k == 0, idx & 0xF, jnp.where(k == 1, (idx >> 4) & 0xF, 0)
                ),
                win,
            ),
        )
        wl = jnp.where(is_lit, 1, jnp.where(is_default, 2, ln))

        new_nybs = jax.lax.dynamic_update_slice(nybs, win, (nlen,))
        nybs = jnp.where(active, new_nybs, nybs)

        # lock-step insert: span (prev_pos, prev_len + 1) in prev_ctx;
        # slots 0x80..0xFF, wrap to 0x80 (only_hi_bit_set)
        tochange = nwi[prev_ctx]
        starts = jnp.where(
            active, starts.at[prev_ctx, tochange].set(prev_pos), starts
        )
        lengths = jnp.where(
            active, lengths.at[prev_ctx, tochange].set(prev_len + 1), lengths
        )
        nxt = jnp.where(tochange + 1 >= 0x100, 0x80, tochange + 1)
        nwi = jnp.where(active, nwi.at[prev_ctx].set(nxt), nwi)

        prev_ctx = jnp.where(active, ctx, prev_ctx)
        prev_pos = jnp.where(active, nlen, prev_pos)
        prev_len = jnp.where(active, wl, prev_len)
        nlen = jnp.where(active, nlen + wl, nlen)
        return (nybs, nlen, starts, lengths, nwi, prev_ctx, prev_pos, prev_len), 0

    first = payload[1]
    nybs0 = jnp.zeros((2 * S + W2MAX,), jnp.int32)
    nybs0 = nybs0.at[0].set(first & 0xF).at[1].set((first >> 4) & 0xF)
    carry0 = (
        nybs0,
        jnp.int32(2),
        jnp.full((32, 256), -1, jnp.int32),
        jnp.zeros((32, 256), jnp.int32),
        jnp.full((32,), 0x80, jnp.int32),
        jnp.int32(ord(" ") & 31),
        jnp.int32(0),
        jnp.int32(2),  # the verbatim first byte's two nybbles
    )
    (nybs, *_), _ = jax.lax.scan(step, carry0, jnp.arange(P - 2))
    pairs = nybs[: 2 * S].reshape(S, 2)
    return (pairs[:, 0] | (pairs[:, 1] << 4)).astype(jnp.uint8)


@functools.partial(jax.jit, static_argnames=("S",))
def _small_nybble_decode_batch(payloads, plens, raw_lens, S):
    return jax.vmap(lambda p, pl, r: _small_nybble_decode_lane(p, pl, r, S))(
        payloads.astype(jnp.int32), plens, raw_lens
    )


def small_nybble_decode_blocks(
    payloads: List[bytes], raw_lens: List[int]
) -> List[bytes]:
    """Device-parallel nybble-LZW decode, one lane per block (the
    block-parallel strategy SURVEY §3.5 prescribes for scheme B,
    small_compression.c:1432-1483)."""
    if not payloads:
        return []
    B = len(payloads)
    P = max(max(len(p) for p in payloads), 3)
    arr = np.zeros((B, P), np.uint8)
    plens = np.zeros(B, np.int32)
    for i, p in enumerate(payloads):
        if len(p) == 0 or p[0] != 8:  # EIGHT_BIT_PRUNED
            raise ValueError(f"block {i}: bad small_nybble stream type byte")
        arr[i, : len(p)] = np.frombuffer(p, np.uint8)
        plens[i] = len(p)
    rl = np.asarray(raw_lens, np.int32)
    S = max(_round_up(int(rl.max(initial=1)), 4096), W2MAX)
    outs = np.asarray(
        _small_nybble_decode_batch(
            jnp.asarray(arr), jnp.asarray(plens), jnp.asarray(rl), S
        )
    )
    return [outs[i, : int(rl[i])].tobytes() for i in range(B)]


def nybble_decode_blocks(payloads: List[bytes], raw_lens: List[int]) -> List[bytes]:
    """Device-parallel decode of framed nybble payloads."""
    if not payloads:
        return []
    B = len(payloads)
    P = max(max(len(p) - 1 for p in payloads), 1)
    arr = np.zeros((B, P), np.uint8)
    for i, p in enumerate(payloads):
        if len(p) == 0 or p[0] != nyb_host.NYBBLES_TYPE:
            raise ValueError(f"block {i}: bad nybble stream type byte")
        body = np.frombuffer(p, np.uint8)[1:]
        arr[i, : body.size] = body
    rl = np.asarray(raw_lens, np.int32)
    # Static scan length: round up so repeated calls share a compile.
    S = max(_round_up(int(rl.max(initial=1)), 4096), 2)
    outs = np.asarray(_decode_batch(jnp.asarray(arr), jnp.asarray(rl), S))
    return [outs[i, : int(rl[i])].tobytes() for i in range(B)]
