"""Batched ungapped maximal extension of match candidates.

Device replacement for MatchFinder::ExtendMatch
(libMems/MatchFinder.h:218-374).  The reference extends one match at a
time with seed-length jumps, unit-step probes, and restarts; the net
semantics (equivalent, and property-tested against the oracle port in
tests/oracle/refimpl.py) is:

    repeatedly jump to the FURTHEST window offset within `seed_len` steps
    at which every member genome's canonical spaced-seed mer is equal with
    consistent strand parity; stop when no window in the next `seed_len`
    offsets matches (or a sequence boundary truncates the probe range).

Here all candidates extend simultaneously: each probe round fetches a
`chunk`-wide window comparison per candidate per side, and the furthest
reachable offset under the gap<=seed_len stepping rule is computed with
vector scans (no per-seed sequential walk).  Left/right extension are
independent (left growth preserves right-side probe coordinates since the
probe anchor is left+length), so the two sides run separately.

Performance structure:

* every probe span is CONTIGUOUS in the key table (backward rows scan
  [l-C, l-1], ahead rows [p+1, p+C]), so the fetch is a batched
  `dynamic_slice` block gather, not an elementwise random gather;
* probe tensors are (rows, C) per genome, the span axis C minor, so
  every elementwise pass over a probe is contiguous;
* spaced seeds extend straight through isolated substitutions, so
  matches are often tens of kb: after one round at the base chunk the
  surviving (long) candidates escalate to an 8x-wide probe window,
  covering length-L matches in O(L/8C) rounds instead of O(L/C).

Parity trick: with canonical key = (content<<1 | strand_bit), the
reference's per-genome parity (MatchFinder.h:283-289: !bit for forward
rows, bit for reverse rows) makes windows match iff
``key ^ is_forward`` is equal across member genomes.

Rows address genomes through per-row (offset, window-count) tables, so a
row may be a dense G-genome match (MemHash mode) or a compact 2-column
pair (PairwiseMatchFinder mode).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


ROW_BLOCK = 4096   # rows extended per sequential block (bounds the live set)
ESCALATE = 8       # long-match probe window = ESCALATE * chunk
# NOTE on row blocking: the lax.map wrapper adds compile time, but the
# compile is one-time-per-shape (persistent cache) while the block
# skipping is a steady-state win every run: blocks whose rows all
# finished skip their probe rounds entirely, which matters when a few
# long matches force many escalated rounds.  Blocking therefore stays
# unconditional above ROW_BLOCK rows.


def _fetch_spans(keys_padded, span_start, C: int):
    """Fetch (R, C) contiguous key spans starting at span_start[r]: one
    batched dynamic_slice.  Every span must lie inside keys_padded
    (dynamic_slice clamps out-of-range starts, which would shift the
    span); callers pad the table by the widest probe on both sides."""
    return jax.vmap(
        lambda s: jax.lax.dynamic_slice(keys_padded, (s,), (C,)))(
        span_start)


@functools.partial(jax.jit, static_argnums=(1, 2))
def extend_matches(
    keys_concat: jax.Array,      # unsigned[Ntot] canonical keys, all genomes
    seed_len: int,
    chunk: int,
    gen_off: jax.Array,          # int32[R, G] offset of the row's genome g
    gen_cnt: jax.Array,          # int32[R, G] window count of the row's genome g
    lefts: jax.Array,            # int32[R, G] 0-based left ends
    present: jax.Array,          # bool[R, G]
    is_fwd: jax.Array,           # bool[R, G] (column 0 / first present = True)
    lengths: jax.Array,          # int32[R] current match length in columns
):
    """Extend candidates to maximal matches. Returns (lefts, lengths).

    Rows are processed in ROW_BLOCK-sized tiles via `lax.map`: the probe
    tensors are (rows, G, chunk) and at full candidate capacity their
    live set would exceed device memory; a block still exposes
    ROW_BLOCK*chunk*G parallel elements, while blocks with no active
    rows skip their probe loops entirely."""
    if chunk < seed_len:
        raise ValueError("chunk must be >= seed_len")
    R_all, G = lefts.shape
    if R_all > ROW_BLOCK:
        nb = -(-R_all // ROW_BLOCK)
        pad = nb * ROW_BLOCK - R_all

        def padb(x, fill=0):
            return jnp.concatenate(
                [x, jnp.full((pad,) + x.shape[1:], fill, x.dtype)]
            ).reshape((nb, ROW_BLOCK) + x.shape[1:])

        def block(args):
            return _extend_block(keys_concat, seed_len, chunk, *args)

        out_l, out_n = jax.lax.map(block, (
            padb(gen_off), padb(gen_cnt, 1), padb(lefts),
            padb(present), padb(is_fwd), padb(lengths)))
        return (out_l.reshape(nb * ROW_BLOCK, G)[:R_all],
                out_n.reshape(nb * ROW_BLOCK)[:R_all])
    return _extend_block(keys_concat, seed_len, chunk, gen_off, gen_cnt,
                         lefts, present, is_fwd, lengths)


def _extend_block(keys_concat, seed_len: int, chunk: int, gen_off, gen_cnt,
                  lefts, present, is_fwd, lengths):
    big = ESCALATE * chunk

    # Sentinel-pad the key table by one max-chunk on each side so probe
    # spans never need clamping (sentinel reads are masked by `valid`).
    fill = ~jnp.zeros((), keys_concat.dtype)
    pad = jnp.full((big,), fill, keys_concat.dtype)
    keys_padded = jnp.concatenate([pad, keys_concat, pad])

    def fetch(span_start, C, aux):
        return _fetch_spans(keys_padded, span_start, C), aux

    lefts, lengths, _ = extend_core(
        fetch, keys_concat.dtype, seed_len, chunk, gen_off, gen_cnt,
        lefts, present, is_fwd, lengths)
    return lefts, lengths


def extend_core(fetch, key_dtype, seed_len: int, chunk: int,
                gen_off, gen_cnt, lefts, present, is_fwd, lengths,
                any_reduce=None, max_chunk: int | None = None,
                aux0=0):
    """The probe-round state machine with a pluggable span fetch.

    `fetch(span_start int32[R], C, aux) -> (keys[R, C], aux)` reads C
    consecutive keys starting at each PADDED global index (offset `big`
    before the first real key; out-of-table reads must return the
    all-ones sentinel).  The local path closes over the padded key
    table; the sharded path (libmems_tpu.parallel.shard) serves spans
    from position-tile owners via an all_to_all request/response, so no
    device ever holds the whole table.  `aux` is fetch-private state
    threaded through every probe round (e.g. an overflow counter) —
    it must be a fixed-structure pytree.

    `any_reduce(bool[...]) -> bool[...]` combines the keep-probing
    predicate; a distributed caller passes a psum-based reduction so
    every device runs the same number of while-loop rounds.  Returns
    (lefts, lengths, aux)."""
    R, G = lefts.shape
    big = ESCALATE * chunk if max_chunk is None else max_chunk
    if any_reduce is None:
        def any_reduce(x):
            return jnp.any(x)

    probe_round = make_probe_round(fetch, key_dtype, seed_len, big,
                                   gen_off, gen_cnt, present, is_fwd)

    def run_side(side, lefts, lengths, aux):
        active0 = jnp.any(present, axis=1)
        # one round at the base chunk retires the short-match bulk ...
        lefts, lengths, active, aux = probe_round(
            side, chunk, lefts, lengths, active0, aux)

        # ... surviving long matches escalate to the max window
        def cond(carry):
            _, _, active, _ = carry
            return any_reduce(active)

        def body(carry):
            lefts, lengths, active, aux = carry
            return probe_round(side, big, lefts, lengths, active, aux)

        lefts, lengths, _, aux = jax.lax.while_loop(
            cond, body, (lefts, lengths, active, aux))
        return lefts, lengths, aux

    aux = jax.tree_util.tree_map(jnp.asarray, aux0)
    lefts, lengths, aux = run_side(0, lefts, lengths, aux)
    lefts, lengths, aux = run_side(1, lefts, lengths, aux)
    return lefts, lengths, aux


def make_probe_round(fetch, key_dtype, seed_len: int, pad_off: int,
                     gen_off, gen_cnt, present, is_fwd):
    """Build the single probe-round function over fixed candidate
    geometry (gen_off/gen_cnt/present/is_fwd never change during
    extension).  Exposed separately from extend_core so distributed
    callers can drive the rounds from the HOST — one jitted collective-
    bearing round per call, no collectives inside a compiled while-loop
    (a structure that once failed to compile on earlier hardware) —
    while extend_core wraps it in an on-device while_loop for the
    local path.  `pad_off` is the sentinel padding before the first real
    key in the fetch's address space."""
    R, G = present.shape
    big = pad_off
    ref_idx = jnp.argmax(present, axis=1).astype(jnp.int32)
    fwd_flip = is_fwd.astype(key_dtype)  # parity adjustment bit
    fill = ~jnp.zeros((), key_dtype)

    def probe_round(side, C, lefts, lengths, active, aux):
        # G is static and small: unroll the genome axis so every probe
        # tensor is (R, C), with no tiny G axis in the layout.
        d = jnp.arange(1, C + 1, dtype=jnp.int32)
        dd = d[None, :]                              # (1, C)
        is_back_all = is_fwd if side == 0 else ~is_fwd  # (R, G)
        back_start_all = lefts - C
        ahead_start_all = lefts + lengths[:, None] - seed_len + 1
        span_start_all = jnp.where(is_back_all, back_start_all,
                                   ahead_start_all) \
            + gen_off + big  # +big: sentinel pad offset

        keys_g = []
        valid_g = []
        for g in range(G):
            l = lefts[:, g:g + 1]                    # (R, 1)
            fwd = is_fwd[:, g:g + 1]
            back_q = l - dd
            ahead_q = l + lengths[:, None] - seed_len + dd
            q = jnp.where(fwd, back_q if side == 0 else ahead_q,
                          ahead_q if side == 0 else back_q)   # (R, C)
            valid_g.append((q >= 0) & (q < gen_cnt[:, g:g + 1]))
            sl, aux = fetch(span_start_all[:, g], C, aux)
            # backward: d -> slice[C-d] = reversed[d-1]; ahead: d -> slice[d-1]
            kg = jnp.where(is_back_all[:, g:g + 1], sl[:, ::-1], sl)
            keys_g.append(kg ^ fwd_flip[:, g:g + 1])

        ref_keys = keys_g[0]
        for g in range(1, G):
            ref_keys = jnp.where(ref_idx[:, None] == g, keys_g[g], ref_keys)
        match = active[:, None]
        # sentinel keys (boundary pad AND ambiguity-masked windows; both
        # carry ~0, whose low bit may be flipped by the parity XOR) can
        # never participate in a match — without this, two N-runs at
        # compatible diagonals would extend through each other
        one = jnp.ones((), key_dtype)
        for g in range(G):
            not_sent = (keys_g[g] | one) != fill
            ok = valid_g[g] & (keys_g[g] == ref_keys) & not_sent
            match = match & jnp.where(present[:, g:g + 1], ok, True)

        # furthest offset reachable with gaps <= seed_len between matches
        dm = jnp.where(match, d[None, :], 0)
        pm_incl = jax.lax.cummax(dm, axis=1)
        pm_excl = jnp.concatenate(
            [jnp.zeros((R, 1), jnp.int32), pm_incl[:, :-1]], axis=1)
        bad = match & (d[None, :] - pm_excl > seed_len)
        first_bad = jnp.min(jnp.where(bad, d[None, :], C + 1), axis=1)
        reach = jnp.max(
            jnp.where(match & (d[None, :] < first_bad[:, None]), d[None, :], 0),
            axis=1)  # (R,)

        # advance: the side's moving genomes shift left by `reach`
        movers = is_fwd if side == 0 else ~is_fwd
        lefts = jnp.where(movers & present & active[:, None],
                          lefts - reach[:, None], lefts)
        lengths = jnp.where(active, lengths + reach, lengths)

        # boundary headroom after advancing: can the chain continue past C?
        back_room = lefts
        ahead_room = (gen_cnt - 1) - (lefts + lengths[:, None] - seed_len)
        room = jnp.where(is_fwd, back_room if side == 0 else ahead_room,
                         ahead_room if side == 0 else back_room)
        room = jnp.min(jnp.where(present, room, jnp.int32(2**30)), axis=1)
        active = active & (reach + seed_len > C) & (room + reach > C)
        return lefts, lengths, active, aux

    return probe_round
