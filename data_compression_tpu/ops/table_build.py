"""On-device n-ary Huffman table construction.

The last host-only stage of the compressor.  With it, the ENTIRE
compress pipeline — histogram, tree build, canonical code assignment,
encode tables, encode, payload compaction — runs on the device
(device_api.compress_blocks_device), which is what a producer whose
data already lives in device memory needs.

The tree build vectorizes the classic two-queue merge ACROSS blocks:
one `lax.scan` step performs one n-ary merge for all B blocks (a few
[B]-wide gathers/selects), so the serial depth is the merge count
(~319 for n=2), not B x merges.  Tie-breaking reproduces
huffman/tree.py exactly — leaves keyed (count, seniority) via a single
int32 sort key, leaf-preferred pops, FIFO internal nodes — so device
lengths are bit-identical to the host builder (differential-tested in
tests/test_table_build.py).  Reference anchor: generate_huffman_tree /
summarize_tree_with_lengths (n_ary_huffman.c:868-1005, :1033-1093) with
the dummy-node % (n-1) fix (tree.py:36-46).

Length capping reproduces capped_lengths' halving rescale with a
`lax.while_loop` over the (rare) blocks whose optimal tree exceeds the
per-arity cap.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from data_compression_tpu.config import ARITY_MAX_LEN

S = 256  # alphabet
MAXD = 64  # >= arity - 2 dummy leaves
NL = S + MAXD  # leaf id space (sorted position); internal ids follow
INF = np.int32(2**31 - 1)


_KM = 4  # merges per merge-scan step


def _take1(mat, idx):
    """mat[b, idx[b]] via one-hot compare+reduce: [B, W], [B] -> [B].
    Out-of-range idx yields 0."""
    io = jax.lax.broadcasted_iota(jnp.int32, mat.shape, 1)
    return jnp.sum(jnp.where(io == idx[:, None], mat, 0), axis=1)


def _set1(mat, idx, val):
    """mat with mat[b, idx[b]] = val[b] via one-hot select; rows whose
    idx is out of range are untouched (the scatter-drop analogue)."""
    io = jax.lax.broadcasted_iota(jnp.int32, mat.shape, 1)
    return jnp.where(io == idx[:, None], val[:, None], mat)


def _geometry(arity: int):
    n1 = arity - 1
    T = (NL - 1) // n1  # max merges
    ids = NL + T  # total id space; parent array gets one dump slot
    return n1, T, ids


def _build_once(hists, arity: int):
    """Uncapped lengths for every block: [B, S] int32 -> [B, S] int32."""
    n1, T, ids = _geometry(arity)
    B = hists.shape[0]
    hists = hists.astype(jnp.int32)
    used = hists > 0
    k = used.sum(axis=1).astype(jnp.int32)  # [B]
    d = jnp.where(k > 0, (n1 - ((k - 1) % n1)) % n1, 0)

    # Leaf sort keys: count * 512 + seniority index (reals in symbol
    # order, then dummies with count 1) — one int32 sort reproduces the
    # host's stable (count, idx) order.
    rank = jnp.cumsum(used, axis=1) - 1  # [B, S] idx of real leaves
    real_key = jnp.where(used, hists * 512 + rank, INF)
    j = jnp.arange(MAXD, dtype=jnp.int32)[None, :]
    dummy_key = jnp.where(j < d[:, None], 512 + k[:, None] + j, INF)
    leaf_keys = jnp.sort(
        jnp.concatenate([real_key, dummy_key], axis=1), axis=1
    )  # [B, NL]
    leaf_counts = jax.lax.shift_right_logical(leaf_keys, 9)
    leaf_idx = leaf_keys & 511

    b_ix = jnp.arange(B, dtype=jnp.int32)
    state = dict(
        lp=jnp.zeros(B, jnp.int32),  # leaf pointer
        nh=jnp.zeros(B, jnp.int32),  # node FIFO head (creation order)
        nt=jnp.zeros(B, jnp.int32),  # node FIFO tail
        remaining=k + d,
        node_cnt=jnp.full((B, T), INF, jnp.int32),
    )

    # _KM merges per lax.scan step; the parent array stays OUT of the
    # scan carry — each merge just emits its child ids (a [B, 2] leaf)
    # and ONE post-scan scatter builds the pointers, so no merge
    # rewrites a full-width [B, ids] array.
    KM = _KM
    TS = -(-T // KM)  # scan steps

    def one_merge(st, t):
        active = st["remaining"] > 1
        lp, nh, nt = st["lp"], st["nh"], st["nt"]
        total = jnp.zeros(B, jnp.int32)
        kids = []
        for _ in range(arity):
            lc = jnp.where(lp < NL, _take1(leaf_counts, lp), INF)
            nc = jnp.where(nh < nt, _take1(st["node_cnt"], nh), INF)
            pick_leaf = lc <= nc
            child = jnp.where(pick_leaf, lp, NL + nh)
            kids.append(jnp.where(active, child, ids))  # dump slot
            total = total + jnp.where(active, jnp.minimum(lc, nc), 0)
            lp = jnp.where(active & pick_leaf, lp + 1, lp)
            nh = jnp.where(active & ~pick_leaf, nh + 1, nh)
        # inactive blocks steer the write out of range (a no-op)
        node_cnt = _set1(
            st["node_cnt"], jnp.where(active, nt, T), total
        )
        nt = jnp.where(active, nt + 1, nt)
        remaining = st["remaining"] - jnp.where(active, n1, 0)
        return (
            dict(lp=lp, nh=nh, nt=nt, remaining=remaining,
                 node_cnt=node_cnt),
            jnp.stack(kids, axis=1),  # [B, arity]
        )

    def merge_step(st, ts):
        # merges past T (the KM-padded tail) are inactive no-ops: every
        # block's `remaining` has reached 1 by then, and node_cnt is
        # never read after the scan.
        outs = []
        for j in range(KM):
            st, kk = one_merge(st, ts * KM + j)
            outs.append(kk)
        return st, jnp.concatenate(outs, axis=1)

    state, ys = jax.lax.scan(
        merge_step, state, jnp.arange(TS, dtype=jnp.int32)
    )
    # ys [TS, B, KM*arity] -> children in pop order [B, TS*KM*arity];
    # child at flat index q was consumed by merge q // arity
    cids = jnp.transpose(ys, (1, 0, 2)).reshape(B, -1)
    pvals = NL + (jnp.arange(cids.shape[1], dtype=jnp.int32) // arity)
    parent = (
        jnp.full((B, ids + 1), -1, jnp.int32)
        .at[b_ix[:, None], cids]
        .set(jnp.broadcast_to(pvals[None, :], cids.shape), mode="drop")
    )[:, :ids]

    # per-internal-id reverse scan (ids descending: parents always
    # have larger ids)
    idepth0 = jnp.zeros((B, T), jnp.int32)

    def depth_step(idepth, iid):
        p = jax.lax.dynamic_slice_in_dim(parent, NL + iid, 1, axis=1)[:, 0]
        pd = _take1(idepth, jnp.clip(p - NL, 0, T - 1))
        col = jnp.where(p >= 0, pd + 1, 0)
        return (
            jax.lax.dynamic_update_slice_in_dim(
                idepth, col[:, None], iid, axis=1
            ),
            None,
        )

    idepth, _ = jax.lax.scan(
        depth_step, idepth0, jnp.arange(T - 1, -1, -1, dtype=jnp.int32)
    )

    # Leaf depths + the map back to symbols, as CHUNKED one-hot
    # contractions: compare+reduce over 32-wide index chunks, which XLA
    # fuses into elementwise loops.
    CH = 32
    pli = parent[:, :NL] - NL  # internal parent idx per sorted pos
    leaf_depth = jnp.zeros((B, NL), jnp.int32)
    for u0 in range(0, T, CH):
        w = min(CH, T - u0)
        dep_c = idepth[:, u0 : u0 + w]
        uu = (u0 + jnp.arange(w, dtype=jnp.int32))[None, None, :]
        eq = pli[:, :, None] == uu
        leaf_depth = leaf_depth + jnp.sum(
            jnp.where(eq, dep_c[:, None, :] + 1, 0), axis=2
        )
    # sorted position -> seniority (leaf_idx) -> symbol (rank): used
    # symbols' seniorities are unique, dummies (seniority >= k) never
    # match a real rank, INF slots carry seniority 511
    lengths = jnp.zeros((B, S), jnp.int32)
    for p0 in range(0, NL, CH):
        li_c = leaf_idx[:, p0 : p0 + CH]
        ld_c = leaf_depth[:, p0 : p0 + CH]
        eq = rank[:, :, None] == li_c[:, None, :]
        lengths = lengths + jnp.sum(
            jnp.where(eq, ld_c[:, None, :], 0), axis=2
        )
    lengths = jnp.where(used, lengths, 0)
    # Degenerate single-symbol alphabet: one digit (tree.py:76-81).
    lengths = jnp.where((k == 1)[:, None] & used, 1, lengths)
    return lengths.astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("arity",))
def huffman_lengths_device(hists: jnp.ndarray, arity: int) -> jnp.ndarray:
    """[B, 256] histograms -> [B, 256] capped canonical code lengths,
    bit-identical to models.huffman.capped_lengths per block."""
    cap = ARITY_MAX_LEN[arity]
    f0 = hists.astype(jnp.int32)
    l0 = _build_once(f0, arity)

    def cond(carry):
        f, lens = carry
        return jnp.any(lens.max(axis=1) > cap)

    def body(carry):
        f, lens = carry
        over = (lens.max(axis=1) > cap)[:, None]
        f = jnp.where(over & (f > 0), (f + 1) // 2, f)
        return f, _build_once(f, arity)

    _, lengths = jax.lax.while_loop(cond, body, (f0, l0))
    return lengths


# ----------------------------------------------------------------------
# On-device canonical code assignment + encode/decode table layouts
# (device mirror of huffman/batched.py, same wire convention)
# ----------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("arity",))
def encode_tables_device(lengths: jnp.ndarray, arity: int):
    """[B, 256] lengths -> (packed [B, 256] uint32 field-packed code
    words, bits [B, 256] int32 field-bit lengths): the tables of
    ops/encode_fast.  Mirrors batched.packed_rows."""
    from data_compression_tpu.ops.encode_fast import BITS_PER_DIGIT

    L = ARITY_MAX_LEN[arity]
    bpd = BITS_PER_DIGIT[arity]
    B = lengths.shape[0]
    lengths = lengths.astype(jnp.int32)
    count = jnp.zeros((B, L + 1), jnp.int32)
    for ln in range(1, L + 1):
        count = count.at[:, ln].set((lengths == ln).sum(axis=1))
    first_code = jnp.zeros((B, L + 1), jnp.int32)
    for ln in range(1, L):
        first_code = first_code.at[:, ln + 1].set(
            (first_code[:, ln] + count[:, ln]) * arity
        )
    # canonical code per symbol without an argsort/scatter pair:
    # code[s] = first_code[len] + rank-within-length, the rank an
    # exclusive prefix count over the symbol axis
    codes = jnp.zeros((B, S), jnp.int32)
    for ln in range(1, L + 1):
        is_ln = lengths == ln
        rank = jnp.cumsum(is_ln.astype(jnp.int32), axis=1) - is_ln
        codes = jnp.where(is_ln, first_code[:, ln : ln + 1] + rank, codes)

    # field-packed code words (pack_encode_table convention); digit
    # extraction via shifts for power-of-two arities, else a
    # select-decomposed power
    packed = jnp.zeros((B, S), jnp.int32)
    log2n = {2: 1, 4: 2, 16: 4}.get(arity)
    pow_tab = np.array([arity**p for p in range(L + 1)], np.int64)
    for m in range(L):
        place = jnp.clip(lengths - 1 - m, 0, L)
        if log2n is not None:
            digit = jax.lax.shift_right_logical(
                codes, place * log2n
            ) & (arity - 1)
        else:
            powv = jnp.zeros_like(place)
            for p in range(L + 1):
                powv = jnp.where(place == p, np.int32(pow_tab[p]), powv)
            digit = (codes // powv) % arity
        packed = packed | jnp.where(m < lengths, digit << (m * bpd), 0)
    bits = lengths * bpd

    return packed.astype(jnp.uint32), bits


@functools.partial(jax.jit, static_argnames=("arity", "pad_to"))
def decode_tables_device(lengths: jnp.ndarray, arity: int, pad_to: int):
    """[B, 256] lengths -> scaled decode tables on device:
    (limit_scaled [B, L+1] i32, base_minus_first [B, L+1] i32,
    symbols [B, 256] i32).  Mirrors batched.decode_rows."""
    L = pad_to
    B = lengths.shape[0]
    lengths = lengths.astype(jnp.int32)
    used = lengths > 0
    n_used = used.sum(axis=1).astype(jnp.int32)

    count = jnp.zeros((B, L + 1), jnp.int32)
    for ln in range(1, L + 1):
        count = count.at[:, ln].set((lengths == ln).sum(axis=1))
    first_code = jnp.zeros((B, L + 1), jnp.int32)
    for ln in range(1, L):
        first_code = first_code.at[:, ln + 1].set(
            (first_code[:, ln] + count[:, ln]) * arity
        )
    base_index = jnp.concatenate(
        [jnp.zeros((B, 1), jnp.int32), jnp.cumsum(count[:, :-1], axis=1)],
        axis=1,
    )
    max_len = lengths.max(axis=1)
    scale = jnp.asarray(
        arity ** (L - np.arange(L + 1, dtype=np.int64)), jnp.int32
    )
    lvec = jnp.arange(L + 1, dtype=jnp.int32)[None, :]
    ok = (lvec >= 1) & (lvec <= max_len[:, None])
    limit = jnp.where(ok, (first_code + count) * scale[None, :], 0)
    limit = jax.lax.associative_scan(jnp.maximum, limit, axis=1)
    bmf = jnp.where(ok, base_index - first_code, 0)

    sym = jnp.arange(S, dtype=jnp.int32)[None, :]
    key = jnp.where(used, lengths * 512 + sym, INF)
    order = jnp.argsort(key, axis=1).astype(jnp.int32)
    pos = jnp.arange(S, dtype=jnp.int32)[None, :]
    symbols = jnp.where(pos < n_used[:, None], order, 0)
    return limit, bmf, symbols
