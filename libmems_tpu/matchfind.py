"""Multi-MUM discovery: global sort + segmented reduction + batched extension.

Device replacement for the reference's k-way SML stream merge + hash
table (MatchFinder::SearchRange / FindMatchSeeds, libMems/MatchFinder.cpp:
128-393; MemHash::FindMatches / EnumerateMatches / AddHashEntry,
libMems/MemHash.cpp:109-251).  Instead of streaming cursors and a 40000-
bucket offset hash, the pipeline is:

1. concat every genome's canonical window keys into one
   (content, genome, position, strand) table and globally sort it
   (one `jax.lax.sort` — the analog of the reference's per-genome sort +
   k-way merge);
2. segmented scans over equal-content runs apply the reference's seed
   enumeration semantics (MemHash.cpp:139-162):
   * default unique-MUM mode: a seed repeated within any member genome
     kills the whole seed (repeat_tolerance=0);
   * runs longer than `repeat_limit` (MER_REPEAT_LIMIT=1000,
     MatchFinder.cpp:166) are skipped wholesale;
3. surviving seeds become candidate match rows whose relative strands are
   assigned from canonical-key strand bits (MemHash::SetDirection,
   MemHash.cpp:189-203);
4. every candidate is extended to a maximal match simultaneously by the
   batched extension kernel (libmems_tpu.ops.extend, replacing
   MatchFinder::ExtendMatch);
5. dedup is an exact row unique: with the reference's semantics, any two
   seeds of the same maximal match extend to identical signed rows, so
   the offset-bucket containment test (MemHash::AddHashEntry) reduces to
   `np.unique` on (starts, length).

Parity with the reference is property-tested against the loop-faithful
oracle in tests/oracle/refimpl.py.
"""

from __future__ import annotations

import functools
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np

from libmems_tpu import _jaxconfig  # noqa: F401
from libmems_tpu import seeds as seedlib
from libmems_tpu import trace
from libmems_tpu.match import MatchArray
from libmems_tpu.ops import segments as seg
from libmems_tpu.ops.extend import extend_matches
from libmems_tpu.sequence import Genome
from libmems_tpu.sml import SortedMerList

MER_REPEAT_LIMIT = 1000  # MatchFinder.cpp:166


# --------------------------------------------------------------------------
# stage 1-2: sorted seed table + run analysis (device)
# --------------------------------------------------------------------------

@jax.jit
def _sorted_seed_table(keys_concat, gid_concat, pos_concat):
    """Globally sort the (content, gid, pos) table; strand rides along."""
    content = keys_concat >> 1
    strand = (keys_concat & 1).astype(jnp.uint8)
    return jax.lax.sort((content, gid_concat, pos_concat, strand),
                        num_keys=3, is_stable=False)


@functools.partial(jax.jit, static_argnums=(4, 5))
def _mum_seed_flags(content, gid, pos, strand, repeat_tolerance: int,
                    repeat_limit: int):
    """Per-row flags for default MemHash seed enumeration.

    Returns (kept_occ, row_id, ref_strand, n_rows) where kept_occ marks the
    first occurrence of each (content, genome) in surviving runs, row_id
    numbers surviving runs densely, and ref_strand broadcasts the run's
    first kept occurrence's strand (the SetDirection reference genome).
    """
    sc = seg.run_starts(content)
    scg = seg.run_starts(content, gid)
    subrun_len = seg.run_lengths(scg)
    max_subrun = seg.segment_max_broadcast(subrun_len, sc)
    ngids = seg.segment_sum_broadcast(scg.astype(jnp.int32), sc)
    runlen = seg.run_lengths(sc)
    # ambiguity-masked windows carry the all-ones sentinel key; their
    # content (~0 >> 1) is unreachable by real seeds and never matches
    not_sent = content != (~jnp.zeros((), content.dtype) >> 1)
    keep_run = (ngids >= 2) & (max_subrun <= repeat_tolerance + 1) \
        & (runlen <= repeat_limit) & not_sent
    kept_occ = scg & keep_run
    rid_at_start = jnp.cumsum((sc & keep_run).astype(jnp.int32)) - 1
    row_id = rid_at_start[seg.start_index(sc)]
    # ref strand: strand of the run's first row (which is the first kept
    # occurrence when the run survives, since sort is (content, gid, pos))
    ref_strand = strand[seg.start_index(sc)]
    n_rows = jnp.where(keep_run.any(), rid_at_start[-1] + 1, 0)
    return kept_occ, row_id, ref_strand, n_rows


@functools.partial(jax.jit, static_argnums=(4,))
def _unique_occ_flags(content, gid, pos, strand, repeat_limit: int):
    """Per-row flags for PairwiseMatchFinder seed enumeration: occurrences
    unique within their genome, in runs of total length <= repeat_limit
    (PairwiseMatchFinder.cpp:37-71)."""
    sc = seg.run_starts(content)
    scg = seg.run_starts(content, gid)
    subrun_len = seg.run_lengths(scg)
    runlen = seg.run_lengths(sc)
    not_sent = content != (~jnp.zeros((), content.dtype) >> 1)
    unique_occ = (subrun_len == 1) & (runlen <= repeat_limit) & not_sent
    run_id = jnp.cumsum(sc.astype(jnp.int32)) - 1
    return unique_occ, run_id


# --------------------------------------------------------------------------
# stage 4: batched extension (device, padded)
# --------------------------------------------------------------------------

def _pad_rows(n: int) -> int:
    """Pad row counts to limit recompilation of the extension kernel."""
    if n <= 256:
        return 256
    p = 1 << (n - 1).bit_length()
    return p


def _cluster_reduce_np(starts: np.ndarray, lengths: np.ndarray,
                       seed_len: int) -> tuple[np.ndarray, np.ndarray]:
    """Host twin of the device diagonal clustering: keep one candidate
    per (participation, strand pattern, diagonal) cluster whose seeds
    are chain-connected (ref-position gaps <= seed_len).  All members of
    a cluster extend to the same maximal match, so dropping non-
    representatives cannot change the deduplicated result set."""
    R, G = starts.shape
    if R == 0:
        return starts, lengths
    present = starts != 0
    pos = np.abs(starts) - 1
    ref_idx = np.argmax(present, axis=1)
    pos_ref = pos[np.arange(R), ref_idx]
    neg = starts < 0
    delta = np.where(present,
                     np.where(neg, pos + pos_ref[:, None],
                              pos - pos_ref[:, None]),
                     np.int64(1) << 62)
    w = np.int64(1) << np.arange(G, dtype=np.int64)
    maskbits = (present * w).sum(axis=1)
    signbits = (neg * w).sum(axis=1)
    order = np.lexsort((pos_ref,) + tuple(
        delta[:, g] for g in range(G - 1, -1, -1)) + (signbits, maskbits))
    sm, ss = maskbits[order], signbits[order]
    sd, sp = delta[order], pos_ref[order]
    sig_change = np.concatenate([[True],
                                 (sm[1:] != sm[:-1]) | (ss[1:] != ss[:-1])
                                 | (sd[1:] != sd[:-1]).any(axis=1)
                                 | (sp[1:] - sp[:-1] > seed_len)])
    reps = order[sig_change]
    return starts[reps], lengths[reps]


def _extend_rows(smls: list[SortedMerList], starts: np.ndarray,
                 lengths: np.ndarray, chunk: int | None = None
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Extend signed candidate rows to maximal matches on device."""
    R, G = starts.shape
    if R == 0:
        return starts, lengths
    seed_len = smls[0].seed_length
    if chunk is None:
        chunk = max(seed_len, 128)

    keys_concat = jnp.concatenate([s.keys for s in smls])
    cnts = np.array([s.n_windows for s in smls], dtype=np.int32)
    offs = np.concatenate([[0], np.cumsum(cnts)[:-1]]).astype(np.int32)

    Rp = _pad_rows(R)
    pad = Rp - R
    starts_p = np.concatenate([starts, np.zeros((pad, G), np.int64)])
    lengths_p = np.concatenate([lengths, np.full((pad,), seed_len, np.int64)])

    present = starts_p != 0
    lefts = (np.abs(starts_p) - 1).astype(np.int32)
    lefts[~present] = 0
    is_fwd = starts_p > 0

    gen_off = np.broadcast_to(offs, (Rp, G))
    gen_cnt = np.broadcast_to(cnts, (Rp, G))

    out_lefts, out_lengths = extend_matches(
        keys_concat, seed_len, chunk,
        jnp.asarray(gen_off), jnp.asarray(gen_cnt), jnp.asarray(lefts),
        jnp.asarray(present), jnp.asarray(is_fwd),
        jnp.asarray(lengths_p.astype(np.int32)))

    out_lefts = np.asarray(out_lefts)[:R]
    out_lengths = np.asarray(out_lengths)[:R].astype(np.int64)
    sign = np.sign(starts[:, :])
    return (sign * (out_lefts.astype(np.int64) + 1)), out_lengths


# --------------------------------------------------------------------------
# fused single-device pipeline (static shapes end to end)
# --------------------------------------------------------------------------

def _diagonal_signature(starts, valid):
    """Per-row diagonal signature for candidate clustering.

    Seeds of one maximal match share (participation mask, strand pattern,
    per-genome diagonal offsets); on a common diagonal, candidates within
    seed_len of each other are chain-connected and extend to the same
    maximal match — so only one representative per cluster needs
    extension.  This is the sort-native equivalent of MemHash's
    dedup-before-extend (AddHashEntry offset buckets, MemHash.cpp:209-251).
    """
    R, G = starts.shape
    present = starts != 0
    pos = jnp.abs(starts).astype(jnp.int64) - 1
    ref_idx = jnp.argmax(present, axis=1)
    pos_ref = jnp.take_along_axis(pos, ref_idx[:, None], 1)[:, 0]
    neg = starts < 0
    # forward member: pos_g - pos_ref constant along the chain;
    # reverse member: pos_g + pos_ref constant
    delta = jnp.where(
        present,
        jnp.where(neg, pos + pos_ref[:, None], pos - pos_ref[:, None]),
        jnp.int64(1) << 62)
    weightsb = jnp.int64(1) << jnp.arange(G, dtype=jnp.int64)
    maskbits = (present.astype(jnp.int64) * weightsb).sum(axis=1)
    signbits = (neg.astype(jnp.int64) * weightsb).sum(axis=1)
    invalid = (~valid).astype(jnp.int64)
    return invalid, maskbits, signbits, delta, pos_ref


_WORD_BITS = 63  # sort-word payload bits (top bit clear: u64 compare safe)


def _pack_sort_words(fields, word_bits: int = _WORD_BITS):
    """Bit-pack (value, nbits) fields — MSB-first lexicographic order —
    into the minimal list of uint64 sort words.  Comparing the word
    tuple in order is identical to comparing the concatenated
    bit-string, i.e. to a lexicographic multi-key sort over the fields,
    so an N-operand K-key `lax.sort` collapses to a 1-3 word sort."""
    total = sum(nb for _, nb in fields)
    n_words = max(1, -(-total // word_bits))
    shape = fields[0][0].shape
    words = [jnp.zeros(shape, jnp.uint64) for _ in range(n_words)]
    off = 0
    for arr, nb in fields:
        a = arr.astype(jnp.uint64)
        start, end = off, off + nb
        for w in range(n_words):
            ws, we = w * word_bits, (w + 1) * word_bits
            lo, hi = max(start, ws), min(end, we)
            if lo >= hi:
                continue
            seg = a >> jnp.uint64(end - hi)
            if hi - lo < 64:
                seg = seg & jnp.uint64((1 << (hi - lo)) - 1)
            words[w] = words[w] | (seg << jnp.uint64(we - hi))
        off = end
    return words


def _unpack_sort_words(words, fields_bits, word_bits: int = _WORD_BITS):
    """Inverse of _pack_sort_words: recover each field as uint64."""
    out = []
    off = 0
    for nb in fields_bits:
        start, end = off, off + nb
        val = jnp.zeros_like(words[0])
        for w, word in enumerate(words):
            ws, we = w * word_bits, (w + 1) * word_bits
            lo, hi = max(start, ws), min(end, we)
            if lo >= hi:
                continue
            seg = word >> jnp.uint64(we - hi)
            if hi - lo < 64:
                seg = seg & jnp.uint64((1 << (hi - lo)) - 1)
            val = val | (seg << jnp.uint64(end - hi))
        out.append(val)
        off = end
    return out


def _packed_diagonal_words(starts, valid, pos_bits: int):
    """Diagonal-cluster signature as packed sort words.

    Fields (MSB->LSB): invalid(1) | participation mask(G) | strand
    bits(G) | biased per-genome diagonal(pos_bits+2 each) — plus
    pos_ref in its own trailing word (the least-significant sort key,
    kept separate so the cluster-gap rule can read it directly).  The
    starts are fully recoverable from these fields (_recover_starts),
    so the capacity-sized sort carries NO payload operands."""
    R, G = starts.shape
    present = starts != 0
    pos = jnp.abs(starts).astype(jnp.int64) - 1
    ref_idx = jnp.argmax(present, axis=1)
    pos_ref = jnp.take_along_axis(pos, ref_idx[:, None], 1)[:, 0]
    neg = starts < 0
    delta = jnp.where(neg, pos + pos_ref[:, None], pos - pos_ref[:, None])
    bias = jnp.int64(1) << (pos_bits + 1)
    delta_b = jnp.where(present, delta + bias, 0)
    wb = jnp.int64(1) << jnp.arange(G, dtype=jnp.int64)
    maskbits = (present.astype(jnp.int64) * wb).sum(axis=1)
    signbits = (neg.astype(jnp.int64) * wb).sum(axis=1)
    invalid = (~valid).astype(jnp.int64)
    fields = [(invalid, 1), (maskbits, G), (signbits, G)]
    for g in range(G):
        fields.append((delta_b[:, g], pos_bits + 2))
    words = _pack_sort_words(fields)
    posref_w = jnp.where(valid, pos_ref, (jnp.int64(1) << 62)
                         ).astype(jnp.uint64)
    return words, posref_w


def _recover_starts(words, posref_sorted, G: int, pos_bits: int):
    """Rebuild signed int32 starts from sorted signature words."""
    fields_bits = [1, G, G] + [pos_bits + 2] * G
    vals = _unpack_sort_words(words, fields_bits)
    invalid = vals[0] != 0
    mask, sign = vals[1], vals[2]
    pos_ref = posref_sorted.astype(jnp.int64)
    bias = jnp.int64(1) << (pos_bits + 1)
    cols = []
    for g in range(G):
        db = vals[3 + g].astype(jnp.int64)
        present = ((mask >> jnp.uint64(g)) & jnp.uint64(1)) == 1
        negg = ((sign >> jnp.uint64(g)) & jnp.uint64(1)) == 1
        delta = db - bias
        posg = jnp.where(negg, delta - pos_ref, delta + pos_ref)
        sgn = jnp.where(negg, -1, 1)
        col = jnp.where(present & ~invalid, sgn * (posg + 1), 0)
        cols.append(col.astype(jnp.int32))
    return jnp.stack(cols, axis=1)


@functools.partial(jax.jit, static_argnums=(0, 1, 2, 3, 4, 5))
def _fused_mum_pipeline(seed_len: int, chunk: int, capacity: int,
                        extend_capacity: int, repeat_limit: int,
                        seq_mask: int,
                        keys_posorder, keys, gid, pos,
                        gen_off, gen_cnt):
    """Seed table -> flags -> candidates -> diagonal clustering ->
    batched extension of representatives -> dedup, on device, static
    shapes throughout.

    Returns (starts int32[extend_capacity, G], lengths, valid bool[...],
    n_rows, n_reps): n_rows = surviving seed runs (must be <= capacity
    for completeness), n_reps = diagonal-cluster representatives (must
    be <= extend_capacity).
    """
    G = gen_off.shape[0]
    content, gids, poss, strand = _sorted_seed_table(keys, gid, pos)
    kept_occ, row_id, ref_strand, n_rows = _mum_seed_flags(
        content, gids, poss, strand, 0, repeat_limit)

    # scatter candidate rows (cheap arrays only at this capacity)
    rid = jnp.where(kept_occ, jnp.minimum(row_id, capacity), capacity)
    starts = jnp.zeros((capacity + 1, G), dtype=jnp.int32)
    sign = jnp.where(strand == ref_strand, 1, -1).astype(jnp.int32)
    starts = starts.at[rid, gids].set(sign * (poss + 1), mode="drop")
    starts = starts[:capacity]
    valid = jnp.arange(capacity) < jnp.minimum(n_rows, capacity)

    if seq_mask:
        # MaskedMemHash::HashMatch (libMems/MaskedMemHash.cpp:38-63):
        # reject seeds whose participation bitmask differs from seq_mask
        # BEFORE they consume clustering/extension capacity.  Bit
        # (G-1-seqI) <-> genome seqI (the reference builds match_number
        # MSB-first over seqI).
        want = jnp.asarray(
            np.array([(seq_mask >> (G - 1 - g)) & 1 for g in range(G)],
                     dtype=bool))
        row_ok = jnp.all((starts != 0) == want[None, :], axis=1)
        starts = jnp.where(row_ok[:, None], starts, 0)
        valid = valid & row_ok

    # diagonal clustering: packed-signature sort (1-3 uint64 key words,
    # no payload — starts are recovered from the signature), then
    # cluster-break on any signature change or ref-position gap > seed_len
    pos_bits = int(keys.shape[0]).bit_length()
    sig_words, posref_w = _packed_diagonal_words(starts, valid, pos_bits)
    n_words = len(sig_words)
    s = jax.lax.sort(tuple(sig_words) + (posref_w,),
                     num_keys=n_words + 1, is_stable=False)
    s_words, s_posref_w = s[:n_words], s[n_words]
    s_starts = _recover_starts(s_words, s_posref_w, G, pos_bits)
    s_posref = s_posref_w.astype(jnp.int64)
    s_valid_rows = jnp.any(s_starts != 0, axis=1)
    word_change = jnp.zeros((capacity - 1,), bool)
    for w in s_words:
        word_change = word_change | (w[1:] != w[:-1])
    sig_change = jnp.concatenate([
        jnp.ones((1,), bool),
        word_change | (s_posref[1:] - s_posref[:-1] > seed_len)])
    rep = sig_change & s_valid_rows
    n_reps = jnp.sum(rep.astype(jnp.int32))

    # compact representatives to the front, slice to extend_capacity:
    # single packed u64 key (non-rep bit | row index keeps it stable) +
    # starts packed pairwise into u64 payload words
    idx_bits = (capacity - 1).bit_length()
    comp_key = ((~rep).astype(jnp.uint64) << jnp.uint64(idx_bits)) \
        | jnp.arange(capacity, dtype=jnp.uint64)
    payload = []
    for g0 in range(0, G, 2):
        hi = s_starts[:, g0].astype(jnp.uint32).astype(jnp.uint64)
        lo = (s_starts[:, g0 + 1].astype(jnp.uint32).astype(jnp.uint64)
              if g0 + 1 < G else jnp.zeros((capacity,), jnp.uint64))
        payload.append((hi << jnp.uint64(32)) | lo)
    comp = jax.lax.sort((comp_key,) + tuple(payload),
                        num_keys=1, is_stable=False)
    e_cols = []
    for g in range(G):
        w = comp[1 + g // 2]
        half = (w >> jnp.uint64(32)) if g % 2 == 0 else \
            (w & jnp.uint64(0xFFFFFFFF))
        e_cols.append(half.astype(jnp.uint32).astype(jnp.int32))
    e_starts = jnp.stack(e_cols, axis=1)[:extend_capacity]
    e_valid = jnp.arange(extend_capacity) < jnp.minimum(
        n_reps, extend_capacity)

    present = (e_starts != 0) & e_valid[:, None]
    lefts = jnp.where(present, jnp.abs(e_starts) - 1, 0)
    is_fwd = e_starts > 0
    lengths = jnp.full((extend_capacity,), seed_len, dtype=jnp.int32)
    lefts, lengths = extend_matches(
        keys_posorder, seed_len, chunk,
        jnp.broadcast_to(gen_off, (extend_capacity, G)),
        jnp.broadcast_to(gen_cnt, (extend_capacity, G)),
        lefts, present, is_fwd, lengths)
    out_starts = jnp.where(present, jnp.sign(e_starts) * (lefts + 1), 0)

    # dedup: lexicographic sort of (starts..., length), mark first of run
    sort_ops = tuple(out_starts[:, g] for g in range(G)) + (
        lengths, (~e_valid).astype(jnp.int32))
    sorted_ops = jax.lax.sort(sort_ops, num_keys=G + 2, is_stable=False)
    srows = jnp.stack(sorted_ops[:G + 1], axis=1)
    svalid = sorted_ops[G + 1] == 0
    first = jnp.concatenate([
        jnp.ones((1,), bool),
        jnp.any(srows[1:] != srows[:-1], axis=1)])
    uniq = svalid & first
    return srows[:, :G], srows[:, G], uniq, n_rows, n_reps


# --------------------------------------------------------------------------
# fused PAIRWISE fast path (G == 2, default unique-MUM semantics)
# --------------------------------------------------------------------------
#
# For two genomes the general machinery above collapses: a seed run
# survives MemHash's repeat_tolerance=0 enumeration iff it has EXACTLY two
# occurrences, one per genome (any longer run puts >=2 occurrences in one
# genome; MemHash.cpp:139-162).  That makes every stage expressible as
# neighbor comparisons on ONE sorted uint64 word — no segmented scans, no
# scatters, no capacity-padded candidate tables (XLA scatter measures
# far slower than sort per element; see PERF.md):
#
#   pack  (content | gid | pos | strand) -> one u64 per window
#   sort  the 2N words (single-operand lax.sort)
#   flags exact-pair runs via shifted compares
#   sort  cluster words (fwd | diagonal | posA) — groups each maximal
#         match's seeds contiguously (replaces MemHash offset buckets)
#   sort  (non-rep | cluster word | capped span) compacts the (rare)
#         cluster representatives to the front; the cluster EXTENT seeds
#         extension lengths so the batched extension kernel probes only
#         the unexplored tails instead of re-walking the whole match span
#   extend + dedup as in the general pipeline.

def _pair_pos_bits(total_windows: int) -> int:
    return max(int(total_windows).bit_length(), 8)


def pair_fast_path_ok(smls) -> bool:
    """Fast path needs the packed seed word (2*weight + 2 + pos_bits + 1
    bits) and the cluster word (2*pos_bits + 4 bits) to fit u64, G == 2."""
    if len(smls) != 2:
        return False
    pb = _pair_pos_bits(max(s.n_windows for s in smls))
    return 2 * smls[0].seed_weight + 3 + pb <= 64 and pb <= 30


@functools.partial(jax.jit, static_argnums=(0, 1, 2, 3, 4))
def _fused_pair_pipeline(seed_len: int, chunk: int, pos_bits: int,
                         extend_capacity: int, repeat_limit: int,
                         keys_posorder, keys_a, keys_b,
                         gen_off, gen_cnt):
    """G=2 unique-MUM pipeline: one packed-word sort + neighbor flags +
    one cluster sort + binary-search compaction + span-seeded extension.
    Static shapes.  (A bitonic-merge variant over pre-sorted per-genome
    words was evaluated and retired: the XLA network was slower than
    lax.sort, and a blocked Pallas version was deleted after it failed
    to compile on the hardware it was written for.)  Returns (starts
    int32[EC, 2], lengths, valid, n_rows, n_reps) with the same
    contract as _fused_mum_pipeline.
    """
    EC = extend_capacity
    pb = pos_bits
    u = jnp.uint64

    def pack(keys, gid):
        content = (keys >> 1).astype(u)
        strand = (keys & 1).astype(u)
        n = keys.shape[0]
        pos = jnp.arange(n, dtype=jnp.uint32).astype(u)
        return (content << u(pb + 2)) | (u(gid) << u(pb + 1)) \
            | (pos << u(1)) | strand

    w = jnp.concatenate([pack(keys_a, 0), pack(keys_b, 1)])
    w = jax.lax.sort(w)

    c = w >> u(pb + 2)
    gid = ((w >> u(pb + 1)) & u(1)).astype(jnp.uint32)
    pos = ((w >> u(1)) & u((1 << pb) - 1)).astype(jnp.int32)
    strand = (w & u(1)).astype(jnp.uint32)

    inf = ~jnp.zeros((1,), c.dtype)

    def nxt(x, k=1, fill=None):
        f = jnp.full((k,), fill if fill is not None else 0, x.dtype)
        return jnp.concatenate([x[k:], f])

    c1 = nxt(c, 1, ~jnp.uint64(0) >> jnp.uint64(pb + 2))
    c2 = nxt(c, 2, ~jnp.uint64(0) >> jnp.uint64(pb + 2))
    cp = jnp.concatenate([inf, c[:-1]])
    g1 = nxt(gid, 1)
    # exact-pair run: len 2, one occurrence per genome (row i = genome 0)
    surv = (c == c1) & (c != cp) & (c1 != c2) & (gid == 0) & (g1 == 1)
    # ambiguity/pad sentinel content (key-dtype ~0 >> 1) never survives
    # — a lone masked window per genome would otherwise mimic an exact
    # pair
    sent_c = (~jnp.zeros((), keys_a.dtype) >> 1).astype(u)
    surv = surv & (c != sent_c)

    posA = pos
    posB = nxt(pos, 1)
    fwd = strand == nxt(strand, 1)

    # cluster word: (fwd | biased diagonal | posA); invalid rows sort last
    delta_b = jnp.where(fwd,
                        (posB - posA + (1 << pb)).astype(u),
                        (posB + posA).astype(u))
    cw = (fwd.astype(u) << u(2 * pb + 2)) | (delta_b << u(pb)) \
        | posA.astype(u)
    cw = jnp.where(surv, cw, ~u(0))
    cw = jax.lax.sort(cw)

    valid_c = cw != ~u(0)
    s_posA = (cw & u((1 << pb) - 1)).astype(jnp.int32)
    head = cw >> u(pb)
    prev_head = jnp.concatenate([inf, head[:-1]])
    prev_posA = jnp.concatenate([jnp.zeros((1,), jnp.int32), s_posA[:-1]])
    rep = valid_c & ((head != prev_head)
                     | (s_posA - prev_posA > seed_len))
    n_cands = jnp.sum(surv.astype(jnp.int32))
    n_reps = jnp.sum(rep.astype(jnp.int32))

    # compact reps to EC slots WITHOUT a third sort: rep ranks are a
    # monotone map (cumsum), so its inverse — the row of the j-th rep —
    # is a binary search over the rank array (24 tiny gather rounds for
    # EC queries), and all representative fields are then EC-sized
    # gathers.  This replaces both a full compaction sort and the
    # segmented span scans (scatter and top_k alternatives are ruled
    # out in PERF.md).
    rank = jnp.cumsum(rep.astype(jnp.int32))
    src = jnp.searchsorted(rank, jnp.arange(1, EC + 1, dtype=jnp.int32),
                           side="left", method="scan_unrolled")
    e_valid = jnp.arange(EC) < n_reps
    src = jnp.minimum(src, cw.shape[0] - 1)
    rep_cw = cw[src]
    r_posA = (rep_cw & u((1 << pb) - 1)).astype(jnp.int32)
    r_delta = ((rep_cw >> u(pb)) & u((1 << (pb + 2)) - 1)).astype(jnp.int32)
    r_fwd = ((rep_cw >> u(2 * pb + 2)) & u(1)) == 1

    # cluster extent: the cluster's last member is the row before the
    # next rep (or the last valid candidate row) — seeds the extension
    # length so the kernel probes only the unexplored tails
    next_src = jnp.concatenate([src[1:], jnp.full((1,), cw.shape[0],
                                                  jnp.int32)])
    end_row = jnp.minimum(next_src, n_cands) - 1
    end_row = jnp.clip(end_row, 0, cw.shape[0] - 1)
    last_posA = (cw[end_row] & u((1 << pb) - 1)).astype(jnp.int32)
    last_posA = jnp.clip(last_posA, r_posA, None)
    span = last_posA - r_posA

    lengths0 = jnp.where(e_valid, span + seed_len, seed_len)
    # genome-B left end of the cluster-covering match
    posB_rep = jnp.where(r_fwd, r_delta - (1 << pb) + r_posA,
                         r_delta - r_posA)
    leftB = jnp.where(r_fwd, posB_rep, r_delta - last_posA)
    leftB = jnp.maximum(leftB, 0)

    lefts = jnp.stack([r_posA, leftB], axis=1)
    present = jnp.broadcast_to(e_valid[:, None], (EC, 2))
    is_fwd = jnp.stack([jnp.ones((EC,), bool), r_fwd], axis=1)
    lefts = jnp.where(present, lefts, 0)
    lefts, lengths = extend_matches(
        keys_posorder, seed_len, chunk,
        jnp.broadcast_to(gen_off, (EC, 2)),
        jnp.broadcast_to(gen_cnt, (EC, 2)),
        lefts, present, is_fwd, lengths0)
    signB = jnp.where(r_fwd, 1, -1)
    out_starts = jnp.stack([
        jnp.where(e_valid, lefts[:, 0] + 1, 0),
        jnp.where(e_valid, signB * (lefts[:, 1] + 1), 0)], axis=1)

    # dedup: lexicographic sort of (starts, length), mark first of run
    sort_ops = (out_starts[:, 0], out_starts[:, 1], lengths,
                (~e_valid).astype(jnp.int32))
    sorted_ops = jax.lax.sort(sort_ops, num_keys=4, is_stable=False)
    srows = jnp.stack(sorted_ops[:3], axis=1)
    svalid = sorted_ops[3] == 0
    first = jnp.concatenate([
        jnp.ones((1,), bool),
        jnp.any(srows[1:] != srows[:-1], axis=1)])
    uniq = svalid & first
    return srows[:, :2], srows[:, 2], uniq, n_cands, n_reps


def find_mums_device(smls: list[SortedMerList], capacity: int | None = None,
                     extend_capacity: int = 1 << 14,
                     chunk: int | None = None,
                     repeat_limit: int = MER_REPEAT_LIMIT,
                     seq_mask: int = 0):
    """Fused device-side find_mums (default unique-MUM semantics).

    One XLA computation: sort + segmented enumeration + diagonal
    clustering + batched extension + dedup, with static capacities.
    Returns (starts, lengths, valid, n_rows, n_reps) device arrays —
    the hot path used by bench.py; `find_mums` is the exact-semantics
    host orchestration.  capacity bounds candidate seed runs (defaults
    to the table size rounded up to a power of two); extend_capacity
    bounds diagonal-cluster representatives.
    """
    seed_len = smls[0].seed_length
    if chunk is None:
        chunk = max(seed_len, 256)
    total = sum(s.n_windows for s in smls)
    # for G == 2 the only mask satisfiable by a multiplicity>=2 match is
    # 0b11 == the fast path's exact-pair semantics
    if pair_fast_path_ok(smls) and seq_mask in (0, 0b11):
        from libmems_tpu.sml import _bucket_len
        extend_capacity = min(extend_capacity,
                              1 << max((total - 1).bit_length() - 1, 1))
        # bucket-pad each genome's key table with the all-ones sentinel:
        # arbitrary genome sizes share compile-cache entries.  Sentinel
        # windows can never survive the pair-run flags (their content
        # runs are longer than 2), and extension never reaches them
        # (gen_cnt carries the REAL window counts).
        pads = [_bucket_len(s.n_windows) for s in smls]
        # a pad of exactly 1 in BOTH genomes would form a 2-row sentinel
        # run that mimics a surviving pair — bump to the next bucket
        pads = [_bucket_len(p + 1) if p - s.n_windows == 1 else p
                for p, s in zip(pads, smls)]
        keys_pad = []
        for s, p in zip(smls, pads):
            sentinel = ~jnp.zeros((), s.keys.dtype)
            keys_pad.append(jnp.concatenate([
                s.keys, jnp.full((p - s.n_windows,), sentinel,
                                 s.keys.dtype)]))
        keys_posorder = jnp.concatenate(keys_pad)
        cnts = jnp.asarray(np.array([s.n_windows for s in smls], np.int32))
        offs = jnp.asarray(np.array([0, pads[0]], np.int32))
        pb = _pair_pos_bits(max(pads))
        if 2 * smls[0].seed_weight + 3 + pb <= 64 and pb <= 30:
            return _fused_pair_pipeline(
                seed_len, chunk, pb, extend_capacity, repeat_limit,
                keys_posorder, keys_pad[0], keys_pad[1], offs, cnts)
        # padded table exceeds the word budget: exact-shape fallback
        keys_posorder = jnp.concatenate([s.keys for s in smls])
        offs = jnp.asarray(np.array([0, smls[0].n_windows], np.int32))
        pb = _pair_pos_bits(max(s.n_windows for s in smls))
        return _fused_pair_pipeline(
            seed_len, chunk, pb, extend_capacity, repeat_limit,
            keys_posorder, smls[0].keys, smls[1].keys, offs, cnts)
    # bucket-stable table layout (PERF.md rule 29): concatenate the
    # SMLs' padded sentinel-tail key arrays so genome families in the
    # same size buckets share one compiled pipeline.  Sentinel runs are
    # not_sent-masked in _mum_seed_flags; gid-62 pad rows only occur in
    # those runs, so they never reach the (mode="drop") scatter kept.
    kp = [s.padded_keys() for s in smls]
    bl = tuple(int(k.shape[0]) for k in kp)
    total_p = sum(bl)
    if capacity is None:
        # every surviving run holds >=2 occurrences (ngids >= 2), so
        # candidate rows are bounded by half the table
        capacity = 1 << max(total_p // 2, 1).bit_length()
    extend_capacity = min(extend_capacity, capacity)
    keys_posorder = jnp.concatenate(kp)
    cnts = jnp.asarray(np.array([s.n_windows for s in smls], np.int32))
    gid, pos = _padded_table_meta(bl, cnts)
    offs = jnp.asarray(np.concatenate(
        [[0], np.cumsum(bl)[:-1]]).astype(np.int32))
    return _fused_mum_pipeline(seed_len, chunk, capacity, extend_capacity,
                               repeat_limit, seq_mask,
                               keys_posorder, keys_posorder, gid, pos,
                               offs, cnts)


# --------------------------------------------------------------------------
# public API
# --------------------------------------------------------------------------

def _as_smls(genomes_or_smls, seed: int | None):
    if all(isinstance(x, SortedMerList) for x in genomes_or_smls):
        smls = list(genomes_or_smls)
        return smls, smls[0].seed
    from libmems_tpu.sml import create_smls
    genomes = [g if isinstance(g, Genome) else Genome.from_string(g)
               for g in genomes_or_smls]
    return create_smls(genomes, seed)


def _seed_table(smls: list[SortedMerList]):
    keys = jnp.concatenate([s.keys for s in smls])
    gid = jnp.concatenate([
        jnp.full((s.n_windows,), i, dtype=jnp.int32)
        for i, s in enumerate(smls)])
    pos = jnp.concatenate([
        jnp.arange(s.n_windows, dtype=jnp.int32) for s in smls])
    return _sorted_seed_table(keys, gid, pos)


def _containment_filter(starts: np.ndarray, lengths: np.ndarray
                        ) -> tuple[np.ndarray, np.ndarray]:
    """Drop matches contained in another match with the same diagonal
    signature (the MemHash offset-bucket containment test,
    MemHash::AddHashEntry / MatchHashEntry::Contains,
    libMems/MemHash.cpp:209-251): for ungapped matches, containment
    implies identical (participation, strand pattern, per-genome
    diagonals), so buckets are the diagonal clusters and containment is
    an interval-cover scan within each."""
    R, G = starts.shape
    if R < 2:
        return starts, lengths
    present = starts != 0
    pos = np.abs(starts) - 1
    ref_idx = np.argmax(present, axis=1)
    pos_ref = pos[np.arange(R), ref_idx]
    neg = starts < 0
    delta = np.where(present,
                     np.where(neg, pos + pos_ref[:, None],
                              pos - pos_ref[:, None]),
                     np.int64(1) << 62)
    w = np.int64(1) << np.arange(G, dtype=np.int64)
    sig = [(present * w).sum(axis=1), (neg * w).sum(axis=1)] \
        + [delta[:, g] for g in range(G)]
    order = np.lexsort((-lengths, pos_ref) + tuple(sig[::-1]))
    s_sig = np.stack(sig, axis=1)[order]
    s_start = pos_ref[order]
    s_end = s_start + lengths[order] - 1
    # within a signature run, sorted by (start asc, length desc): a row
    # is contained iff some earlier row's end reaches its end.  The
    # per-run prefix max is one global maximum.accumulate over
    # seg_id-offset ends (rows of earlier runs can never dominate).
    seg_start = np.concatenate([[True],
                                (s_sig[1:] != s_sig[:-1]).any(axis=1)])
    seg_id = np.cumsum(seg_start) - 1
    offset = np.int64(s_end.max()) + 1
    e = seg_id * offset + s_end
    prev_max = np.concatenate([[np.int64(-1)],
                               np.maximum.accumulate(e)[:-1]])
    contained = (prev_max - seg_id * offset) >= s_end
    keep = np.ones(R, dtype=bool)
    keep[order[contained]] = False
    return starts[keep], lengths[keep]


def find_mums(genomes_or_smls, seed: int | None = None,
              repeat_tolerance: int = 0,
              repeat_limit: int = MER_REPEAT_LIMIT,
              min_multiplicity: int = 2,
              extend: bool = True,
              enumeration_tolerance: int = 1,
              seq_mask: int = 0) -> MatchArray:
    """Find multi-MUMs across N genomes (MemHash::FindMatches equivalent).

    Default semantics match MemHash with repeat_tolerance=0 /
    enumeration_tolerance=1: only seeds unique within every participating
    genome generate matches (unique multi-MUMs).  The default path runs
    the fused device pipeline (sort + enumeration + diagonal clustering +
    extension in one XLA computation); tolerance>0 / no-extend modes use
    the host orchestration below.  enumeration_tolerance>1 emits every
    cross-genome combination of each surviving seed's first
    `enumeration_tolerance` occurrences per genome (the odometer loop of
    MatchFinder::EnumerateMatches, libMems/MatchFinder.cpp:342-393,
    driven by MemHash::EnumerateMatches, MemHash.cpp:139-162).

    seq_mask != 0 keeps only seeds whose genome-participation bitmask
    equals seq_mask, rejected BEFORE extension — MaskedMemHash::HashMatch
    (libMems/MaskedMemHash.cpp:38-63), the n-way-only searcher of
    SearchLCBGaps (Aligner.cpp:2208-2212).  Bit (G-1-seqI) <-> genome
    seqI.
    """
    smls, seed = _as_smls(genomes_or_smls, seed)
    G = len(smls)
    if seq_mask and bin(seq_mask).count("1") < max(2, min_multiplicity):
        return MatchArray.empty(G)
    if enumeration_tolerance > 1:
        return _find_mums_enumerated(
            smls, repeat_tolerance, enumeration_tolerance, repeat_limit,
            min_multiplicity, extend, seq_mask)
    if repeat_tolerance == 0 and extend:
        starts, lengths, valid, n_rows, n_reps = find_mums_device(
            smls, repeat_limit=repeat_limit, seq_mask=seq_mask)
        n_reps = int(n_reps)
        if n_reps > valid.shape[0]:
            # rare: more diagonal-cluster representatives than the default
            # extension capacity — rerun with the exact requirement
            starts, lengths, valid, n_rows, n_reps = find_mums_device(
                smls, repeat_limit=repeat_limit, seq_mask=seq_mask,
                extend_capacity=1 << (int(n_reps) - 1).bit_length())
        v = np.asarray(valid)
        out = MatchArray(np.asarray(starts)[v].astype(np.int64),
                         np.asarray(lengths)[v].astype(np.int64)).dedup()
        if min_multiplicity > 2:
            keep = out.multiplicity() >= min_multiplicity
            out = MatchArray(out.starts[keep], out.lengths[keep])
        return out.canonical_sort()
    content, gid, pos, strand = _seed_table(smls)
    kept_occ, row_id, ref_strand, n_rows = _mum_seed_flags(
        content, gid, pos, strand, repeat_tolerance, repeat_limit)

    n_rows = int(n_rows)
    kept = np.asarray(kept_occ)
    if n_rows == 0 or not kept.any():
        return MatchArray.empty(G)

    rid = np.asarray(row_id)[kept]
    g = np.asarray(gid)[kept]
    p = np.asarray(pos)[kept].astype(np.int64)
    st = np.asarray(strand)[kept]
    ref_st = np.asarray(ref_strand)[kept]

    starts = np.zeros((n_rows, G), dtype=np.int64)
    sign = np.where(st == ref_st, 1, -1).astype(np.int64)
    starts[rid, g] = sign * (p + 1)

    if seq_mask:
        want = np.array([(seq_mask >> (G - 1 - gi)) & 1 for gi in range(G)],
                        dtype=bool)
        starts = starts[((starts != 0) == want[None, :]).all(axis=1)]
        n_rows = len(starts)
        if n_rows == 0:
            return MatchArray.empty(G)

    seed_len = smls[0].seed_length
    lengths = np.full((n_rows,), seed_len, dtype=np.int64)
    if extend:
        starts, lengths = _cluster_reduce_np(starts, lengths, seed_len)
        starts, lengths = _extend_rows(smls, starts, lengths)
    out = MatchArray(starts, lengths).dedup()
    if min_multiplicity > 2:
        out = MatchArray(out.starts[out.multiplicity() >= min_multiplicity],
                         out.lengths[out.multiplicity() >= min_multiplicity])
    return out.canonical_sort()


def _find_mums_enumerated(smls, repeat_tolerance: int,
                          enumeration_tolerance: int, repeat_limit: int,
                          min_multiplicity: int, extend: bool,
                          seq_mask: int = 0
                          ) -> MatchArray:
    """Host orchestration of the enumeration_tolerance>1 semantics:
    per surviving seed run, emit every cross-genome combination of each
    genome's first `enumeration_tolerance` occurrences (position order),
    with per-combination strand reference = the combination's first
    occurrence (MemHash::EnumerateMatches -> MatchFinder::
    EnumerateMatches odometer + SetDirection, MemHash.cpp:139-203).

    The odometer is fully vectorized: per-run mixed-radix strides turn
    the cross product into one flat index calculation over all
    combinations of all runs at once (the array generalization of the
    fori_loop pair expansion; no per-run interpreter loop)."""
    G = len(smls)
    et = enumeration_tolerance
    content, gid, pos, strand = (np.asarray(x) for x in _seed_table(smls))
    n = len(content)
    if n == 0:
        return MatchArray.empty(G)
    # reference arrival order within a genome's run is SML order =
    # (canonical key, pos) = (strand bit, pos) within equal content
    order = np.lexsort((pos, strand, gid, content))
    content, gid, pos, strand = (x[order] for x in
                                 (content, gid, pos, strand))
    # masked-window sentinel runs never enumerate
    sent_c = np.int64(-1) if content.dtype == np.int64 else \
        (~content.dtype.type(0) >> content.dtype.type(1))
    run_start = np.concatenate([[True], content[1:] != content[:-1]])
    sub_start = run_start | np.concatenate(
        [[True], gid[1:] != gid[:-1]])
    run_id = np.cumsum(run_start) - 1
    # per-(run, gid) occurrence rank
    idx = np.arange(n)
    sub_first = idx[sub_start][np.cumsum(sub_start) - 1]
    occ_rank = idx - sub_first
    # per-run per-genome counts + run survival
    counts = np.zeros((run_id[-1] + 1, G), dtype=np.int64)
    np.add.at(counts, (run_id, gid), 1)
    run_len = counts.sum(axis=1)
    survive = (counts.max(axis=1) <= repeat_tolerance + 1) \
        & ((counts > 0).sum(axis=1) >= 2) & (run_len <= repeat_limit) \
        & (content[np.flatnonzero(run_start)] != sent_c)
    if seq_mask:
        want = np.array([(seq_mask >> (G - 1 - gi)) & 1
                         for gi in range(G)], dtype=bool)
        survive &= ((counts > 0) == want[None, :]).all(axis=1)

    seed_len = smls[0].seed_length
    sel_runs = np.flatnonzero(survive)
    if len(sel_runs) == 0:
        return MatchArray.empty(G)
    Rn = len(sel_runs)
    run_map = np.full(counts.shape[0], -1, dtype=np.int64)
    run_map[sel_runs] = np.arange(Rn)

    kept = survive[run_id] & (occ_rank < et)
    k = np.flatnonzero(kept)
    rix = run_map[run_id[k]]
    pos_tab = np.zeros((Rn, G, et), dtype=np.int64)
    str_tab = np.zeros((Rn, G, et), dtype=np.uint8)
    pos_tab[rix, gid[k], occ_rank[k]] = pos[k]
    str_tab[rix, gid[k], occ_rank[k]] = strand[k]

    kc = np.minimum(counts[sel_runs], et)            # [Rn, G]
    kc1 = np.maximum(kc, 1)
    # mixed-radix strides: stride[:, g] = prod_{g' > g} kc1[:, g']
    rev_cp = np.cumprod(kc1[:, ::-1], axis=1)[:, ::-1]
    n_combos = rev_cp[:, 0]
    stride = np.concatenate(
        [rev_cp[:, 1:], np.ones((Rn, 1), dtype=np.int64)], axis=1)
    offs = np.concatenate([[0], np.cumsum(n_combos)[:-1]])
    T = int(n_combos.sum())
    t_run = np.repeat(np.arange(Rn), n_combos)
    t_loc = np.arange(T, dtype=np.int64) - offs[t_run]
    occ_sel = (t_loc[:, None] // stride[t_run]) % kc1[t_run]  # [T, G]
    present = kc[t_run] > 0
    t_ar = np.arange(T)
    pos_sel = pos_tab[t_run[:, None], np.arange(G)[None, :], occ_sel]
    str_sel = str_tab[t_run[:, None], np.arange(G)[None, :], occ_sel]
    first_g = np.argmax(kc > 0, axis=1)[t_run]
    ref_st = str_sel[t_ar, first_g]
    sign = np.where(str_sel == ref_st[:, None], 1, -1)
    starts = np.where(present, sign * (pos_sel + 1), 0)
    lengths = np.full((T,), seed_len, dtype=np.int64)
    if extend:
        starts, lengths = _cluster_reduce_np(starts, lengths, seed_len)
        starts, lengths = _extend_rows(smls, starts, lengths)
    out = MatchArray(starts, lengths).dedup()
    s2, l2 = _containment_filter(out.starts, out.lengths)
    out = MatchArray(s2, l2)
    if min_multiplicity > 2:
        keep = out.multiplicity() >= min_multiplicity
        out = MatchArray(out.starts[keep], out.lengths[keep])
    return out.canonical_sort()


def _chunk_rows_to_matches(smls, content, gid, pos, strand,
                           repeat_limit: int) -> MatchArray:
    """Run seed enumeration + clustering + extension on one sorted
    content-range slice of the seed table (host orchestration)."""
    G = len(smls)
    kept_occ, row_id, ref_strand, n_rows = _mum_seed_flags(
        jnp.asarray(content), jnp.asarray(gid), jnp.asarray(pos),
        jnp.asarray(strand), 0, repeat_limit)
    n_rows = int(n_rows)
    kept = np.asarray(kept_occ)
    if n_rows == 0 or not kept.any():
        return MatchArray.empty(G)
    rid = np.asarray(row_id)[kept]
    g = gid[kept]
    p = pos[kept].astype(np.int64)
    st = strand[kept]
    ref_st = np.asarray(ref_strand)[kept]
    starts = np.zeros((n_rows, G), dtype=np.int64)
    sign = np.where(st == ref_st, 1, -1).astype(np.int64)
    starts[rid, g] = sign * (p + 1)
    seed_len = smls[0].seed_length
    lengths = np.full((n_rows,), seed_len, dtype=np.int64)
    starts, lengths = _cluster_reduce_np(starts, lengths, seed_len)
    starts, lengths = _extend_rows(smls, starts, lengths)
    return MatchArray(starts, lengths)


def find_mums_checkpointed(genomes_or_smls, state_path: str,
                           seed: int | None = None, n_chunks: int = 8,
                           repeat_limit: int = MER_REPEAT_LIMIT,
                           min_multiplicity: int = 2) -> MatchArray:
    """Resumable multi-MUM search: the device analog of the reference's
    match-search checkpointing (MemHash::FindMatchesFromPosition + the
    SML offset log, libMems/MemHash.cpp:109-127, MatchFinder.h:75-81,
    and MemHash::WriteFile/LoadFile match persistence, cpp:266-327).

    The canonical seed-content space is split at run boundaries into
    n_chunks ranges, processed in order.  After each range the partial
    match list (reference match-list-v3 text format) and a cursor are
    persisted:  state_path + ".json" holds {seed, n_chunks, next_chunk};
    state_path + ".matches" holds matches found so far.  Re-invocation
    with the same inputs resumes at the first unfinished range; a
    completed state returns the final list without re-searching.
    Results are identical to find_mums (every equal-content run falls
    entirely inside one range, and extension probes the full genomes).
    """
    import json
    import os

    from libmems_tpu.match import read_match_list, write_match_list

    smls, seed_pat = _as_smls(genomes_or_smls, seed)
    G = len(smls)
    meta_path = state_path + ".json"
    matches_path = state_path + ".matches"
    total = sum(s.n_windows for s in smls)

    meta = None
    if os.path.exists(meta_path):
        with open(meta_path) as fh:
            meta = json.load(fh)
        if meta.get("seed") != int(seed_pat) or \
                meta.get("total_windows") != total or \
                meta.get("n_chunks") != n_chunks:
            meta = None  # stale state for different inputs: restart
    acc = MatchArray.empty(G)
    next_chunk = 0
    if meta is not None:
        next_chunk = int(meta["next_chunk"])
        if os.path.exists(matches_path):
            acc, _, _ = read_match_list(matches_path)

    def finalize(m: MatchArray) -> MatchArray:
        m = m.dedup()
        if min_multiplicity > 2:
            keep = m.multiplicity() >= min_multiplicity
            m = MatchArray(m.starts[keep], m.lengths[keep])
        return m.canonical_sort()

    if meta is not None and next_chunk >= n_chunks:
        return finalize(acc)

    content, gid, pos, strand = (np.asarray(a)
                                 for a in _seed_table(smls))
    # chunk boundaries at run starts so no equal-content run straddles
    cuts = [0]
    for c in range(1, n_chunks):
        b = min(c * total // n_chunks, total)
        b = int(np.searchsorted(content, content[min(b, total - 1)],
                                side="left")) if total else 0
        cuts.append(max(b, cuts[-1]))
    cuts.append(total)

    filenames = [getattr(s, "filename", "") or "null" for s in smls]
    seq_lengths = [int(s.length) for s in smls]
    for c in range(next_chunk, n_chunks):
        lo, hi = cuts[c], cuts[c + 1]
        if hi > lo:
            part = _chunk_rows_to_matches(
                smls, content[lo:hi], gid[lo:hi], pos[lo:hi],
                strand[lo:hi], repeat_limit)
            if part.n_matches:
                acc = MatchArray.concat([acc, part])
        write_match_list(matches_path + ".tmp", acc, filenames, seq_lengths)
        os.replace(matches_path + ".tmp", matches_path)
        with open(meta_path + ".tmp", "w") as fh:
            json.dump({"seed": int(seed_pat), "n_chunks": n_chunks,
                       "next_chunk": c + 1, "total_windows": total}, fh)
        os.replace(meta_path + ".tmp", meta_path)
    return finalize(acc)


@functools.partial(jax.jit, static_argnums=(0, 1, 2, 3, 4, 5, 6))
def _fused_pairwise_pipeline(seed_len: int, chunk: int, G: int,
                             pos_bits: int, rid_bits: int,
                             extend_capacity: int, repeat_limit: int,
                             keys_posorder, keys, gid, pos,
                             gen_off, gen_cnt):
    """PairwiseMatchFinder semantics fused on device: per-genome-unique
    seed occurrences -> all-genome-pair expansion as (G-1) shifted
    neighbor compares over the kept-occurrence compaction -> one
    diagonal-cluster sort -> binary-search compaction -> span-seeded
    extension -> dedup.  Only the final [EC, G] rows ever leave the
    device (the host-orchestrated twin fetched the whole seed table —
    hundreds of MB at genome scale; see PERF.md transfer rules).

    Layout requirements (checked by the caller):
      rid(rid_bits) | gid(6) | pos(pos_bits) | strand(1)  <= 63 bits
      fwd(1) | pair_id(2*ceil(log2 G)) | delta(pos_bits+2) | posA(pos_bits)
                                                           <= 64 bits
    """
    content, gids, poss, strand = _sorted_seed_table(keys, gid, pos)
    unique_occ, run_id = _unique_occ_flags(content, gids, poss, strand,
                                           repeat_limit)
    return _pairwise_core(seed_len, chunk, G, pos_bits, rid_bits,
                          extend_capacity, keys_posorder, content, gids,
                          poss, strand, unique_occ, run_id,
                          gen_off, gen_cnt)


def _pairwise_core(seed_len: int, chunk: int, G: int, pos_bits: int,
                   rid_bits: int, extend_capacity: int, keys_posorder,
                   content, gids, poss, strand, unique_occ, run_id,
                   gen_off, gen_cnt, vary=None):
    """Pair enumeration + clustering + extension + dedup over an
    already-sorted (content, gid, pos, strand) table with unique-occ
    flags.  Shared by the single-device fused pipeline above and the
    seed-prefix-sharded seeder (parallel.shard.sharded_find_pairwise_
    mums), whose routed local tables have the same structure — runs are
    shard-local by construction, so this core needs no communication."""
    EC = extend_capacity
    u = jnp.uint64
    n = content.shape[0]
    gid_bits = 6
    pair_bits = 2 * max(G - 1, 1).bit_length()
    if vary is None:
        def vary(x):
            # identity outside shard_map; the sharded caller passes a
            # pvary that marks loop-carry seeds device-varying
            return x

    # compact kept occurrences to the front, preserving table order
    idx_bits = (n + 1).bit_length()
    ck = ((~unique_occ).astype(u) << u(idx_bits)) \
        | jnp.arange(n, dtype=u)
    payload = (run_id.astype(u) << u(gid_bits + pos_bits + 1)) \
        | (gids.astype(u) << u(pos_bits + 1)) \
        | (poss.astype(u) << u(1)) | strand.astype(u)
    _, payload = jax.lax.sort((ck, payload), num_keys=1, is_stable=False)
    kept_count = jnp.sum(unique_occ.astype(jnp.int32))

    rid_mask = u((1 << rid_bits) - 1)
    rid = (payload >> u(gid_bits + pos_bits + 1)) & rid_mask
    gidc = ((payload >> u(pos_bits + 1))
            & u((1 << gid_bits) - 1)).astype(jnp.int32)
    posc = ((payload >> u(1))
            & u((1 << pos_bits) - 1)).astype(jnp.int32)
    strc = (payload & u(1)).astype(jnp.int32)

    # (G-1) shifted compares: within a surviving run the kept rows are
    # contiguous and gid-sorted (<=1 per genome), so every unordered
    # genome pair of the run appears at exactly one shift.  A fori_loop
    # keeps the HLO O(1) in G (an unrolled version compiled for minutes).
    row = jnp.arange(n, dtype=jnp.int32)
    in_kept = row < kept_count
    bias = 1 << (pos_bits)

    def shift_body(s, cwbuf):
        rid_j = jnp.roll(rid, -s)
        gid_b = jnp.roll(gidc, -s)
        pos_b = jnp.roll(posc, -s)
        str_b = jnp.roll(strc, -s)
        valid = in_kept & (row + s < kept_count) & (row + s < n) \
            & (rid == rid_j)
        fwd = strc == str_b
        pair_id = (gidc * G + gid_b).astype(u)
        delta = jnp.where(fwd, pos_b - posc + bias, pos_b + posc)
        wrd = (fwd.astype(u) << u(pair_bits + 2 * pos_bits + 2)) \
            | (pair_id << u(2 * pos_bits + 2)) \
            | (delta.astype(u) << u(pos_bits)) | posc.astype(u)
        return cwbuf.at[s - 1].set(jnp.where(valid, wrd, ~u(0)))

    cw0 = vary(jnp.zeros((G - 1, n), u))
    cw = jax.lax.fori_loop(1, G, shift_body, cw0).reshape(-1)
    cw = jax.lax.sort(cw)

    inf = ~jnp.zeros((1,), u)
    valid_c = cw != ~u(0)
    s_posA = (cw & u((1 << pos_bits) - 1)).astype(jnp.int32)
    head = cw >> u(pos_bits)
    prev_head = jnp.concatenate([inf, head[:-1]])
    prev_posA = jnp.concatenate([jnp.zeros((1,), jnp.int32), s_posA[:-1]])
    rep = valid_c & ((head != prev_head)
                     | (s_posA - prev_posA > seed_len))
    n_cands = jnp.sum(valid_c.astype(jnp.int32))
    n_reps = jnp.sum(rep.astype(jnp.int32))

    # binary-search compaction of representatives (PERF.md rules 6/8)
    rank = jnp.cumsum(rep.astype(jnp.int32))
    src = jnp.searchsorted(rank, jnp.arange(1, EC + 1, dtype=jnp.int32),
                           side="left", method="scan_unrolled")
    e_valid = jnp.arange(EC) < n_reps
    src = jnp.minimum(src, cw.shape[0] - 1)
    rep_cw = cw[src]
    r_posA = (rep_cw & u((1 << pos_bits) - 1)).astype(jnp.int32)
    r_delta = ((rep_cw >> u(pos_bits))
               & u((1 << (pos_bits + 2)) - 1)).astype(jnp.int32)
    r_pair = ((rep_cw >> u(2 * pos_bits + 2))
              & u((1 << pair_bits) - 1)).astype(jnp.int32)
    r_fwd = ((rep_cw >> u(pair_bits + 2 * pos_bits + 2)) & u(1)) == 1
    r_a = jnp.clip(r_pair // G, 0, G - 1)   # invalid rows decode to
    r_b = jnp.clip(r_pair % G, 0, G - 1)    # garbage; present masks them

    # cluster extent seeds the extension length (probe only the tails)
    next_src = jnp.concatenate([src[1:], jnp.full((1,), cw.shape[0],
                                                  jnp.int32)])
    end_row = jnp.minimum(next_src, n_cands) - 1
    end_row = jnp.clip(end_row, 0, cw.shape[0] - 1)
    last_posA = (cw[end_row] & u((1 << pos_bits) - 1)).astype(jnp.int32)
    last_posA = jnp.clip(last_posA, r_posA, None)
    span = last_posA - r_posA
    lengths0 = jnp.where(e_valid, span + seed_len, seed_len)

    posB_rep = jnp.where(r_fwd, r_delta - bias + r_posA, r_delta - r_posA)
    leftB = jnp.where(r_fwd, posB_rep, r_delta - last_posA)
    leftB = jnp.maximum(leftB, 0)

    # extension in COMPACT pair layout: each row addresses its two
    # member genomes through per-row (offset, count) tables, so the
    # probe tensors are [EC, 2, C] regardless of G — 2/G the probe
    # traffic and O(1)-in-G HLO (the [EC, G] layout at G=9 was ~4.5x
    # the work and the compile)
    rows_i = jnp.arange(EC, dtype=jnp.int32)
    lefts2 = jnp.stack([r_posA, leftB], axis=1)
    present2 = jnp.broadcast_to(e_valid[:, None], (EC, 2))
    is_fwd2 = jnp.stack([jnp.ones((EC,), bool), r_fwd], axis=1)
    gen_off2 = jnp.stack([gen_off[r_a], gen_off[r_b]], axis=1)
    gen_cnt2 = jnp.stack([gen_cnt[r_a], gen_cnt[r_b]], axis=1)
    lefts2 = jnp.where(present2, lefts2, 0)
    lefts2, lengths = extend_matches(
        keys_posorder, seed_len, chunk, gen_off2, gen_cnt2,
        lefts2, present2, is_fwd2, lengths0)
    signB = jnp.where(r_fwd, 1, -1)
    startA = jnp.where(e_valid, lefts2[:, 0] + 1, 0)
    startB = jnp.where(e_valid, signB * (lefts2[:, 1] + 1), 0)
    out_starts = jnp.zeros((EC, G), jnp.int32) \
        .at[rows_i, r_a].set(startA) \
        .at[rows_i, r_b].set(startB)
    out_starts = jnp.where(e_valid[:, None], out_starts, 0)

    # dedup: lexicographic sort of (starts..., length), mark first of run
    sort_ops = tuple(out_starts[:, g] for g in range(G)) + (
        lengths, (~e_valid).astype(jnp.int32))
    sorted_ops = jax.lax.sort(sort_ops, num_keys=G + 2, is_stable=False)
    srows = jnp.stack(sorted_ops[:G + 1], axis=1)
    svalid = sorted_ops[G + 1] == 0
    first = jnp.concatenate([
        jnp.ones((1,), bool),
        jnp.any(srows[1:] != srows[:-1], axis=1)])
    uniq = svalid & first
    return srows[:, :G], srows[:, G], uniq, n_cands, n_reps


# expansion-table budget for the fused pairwise path: (G-1) * n rows.
# Route-only (above it the host orchestration gives the same MUMs); the
# value was set on earlier hardware; re-tune it on the GPU.
_PAIRWISE_FUSED_MAX_ROWS = int(os.environ.get(
    "LIBMEMS_TPU_PAIRWISE_FUSED_MAX_ROWS", 1 << 28))


def pairwise_fused_fits(G: int, pos_bits: int, rid_bits: int) -> bool:
    """Word-budget test for _fused_pairwise_pipeline, mirroring its
    packed layouts EXACTLY:

      kept word:    rid(rid_bits) | gid(6) | pos(pos_bits) | strand(1)
                    must fit 63 bits (top bit clear for u64 compare);
      cluster word: fwd(1) | pair_id(2*ceil(log2(G-1)) bits) |
                    delta(pos_bits+2) | posA(pos_bits) must fit 64.

    Unit-tested against the pipeline's shifts (an over-count here once
    silently routed genome-scale runs onto the ~100x-slower host
    fallback)."""
    pair_bits = 2 * max(G - 1, 1).bit_length()
    return (rid_bits + 6 + pos_bits + 1 <= 63
            and 1 + pair_bits + 2 * pos_bits + 2 <= 64
            and G <= 63)


@functools.partial(jax.jit, static_argnums=(0,))
def _padded_table_meta(bl: tuple, cnts: jax.Array):
    """(gid, pos) arrays for the padded concatenated seed-table layout:
    segment i spans bl[i] rows; rows past cnts[i] are sentinel pads and
    get the reserved genome id 62.  bl is static (bucket lengths), cnts
    traced — one executable per bucket configuration.  Built from iota
    + a G-element searchsorted so the executable carries only a [G]
    constant (an np.repeat table here would bake 4*total bytes of
    constants into the cache entry and its every load)."""
    total_p = int(sum(bl))
    bounds = jnp.asarray(np.cumsum(bl).astype(np.int32)) if bl else \
        jnp.zeros((0,), jnp.int32)
    starts = jnp.asarray(
        np.concatenate([[0], np.cumsum(bl)[:-1]]).astype(np.int32)
        if bl else np.zeros((0,), np.int32))
    r = jnp.arange(total_p, dtype=jnp.int32)
    seg_id = jnp.searchsorted(bounds, r, side="right").astype(jnp.int32)
    local = r - starts[seg_id]
    gid = jnp.where(local < cnts[seg_id], seg_id, 62)
    return gid, local


def find_pairwise_mums(genomes_or_smls, seed: int | None = None,
                       repeat_limit: int = MER_REPEAT_LIMIT,
                       extend: bool = True,
                       extend_capacity: int = 1 << 14) -> MatchArray:
    """Find all pairwise MUMs from per-genome-unique seeds
    (PairwiseMatchFinder::EnumerateMatches equivalent,
    libMems/PairwiseMatchFinder.cpp:37-71) — the progressiveMauve seeder.

    Default path is the fused device pipeline; the host orchestration
    below remains as fallback for layouts that exceed the packed-word
    bit budget and as the parity oracle."""
    smls, seed = _as_smls(genomes_or_smls, seed)
    G = len(smls)
    total = sum(s.n_windows for s in smls)
    # every shape below derives from the BUCKETED per-genome lengths, so
    # genome families whose members fall in the same sqrt(2)-spaced
    # buckets share one compiled seeder end to end.  The previous layout
    # bucket-padded only the concatenated total: the per-genome
    # jnp.concatenate/arange shapes still tracked exact sizes and every
    # new family paid eager-op compiles that outweighed the device
    # compute (PERF.md rule 29)
    kp = [s.padded_keys() for s in smls]
    bl = tuple(int(k.shape[0]) for k in kp)
    total_p = sum(bl)
    pos_bits = max(max(bl, default=1).bit_length(), 8)
    rid_bits = (2 * total_p + 1).bit_length()
    fits = pairwise_fused_fits(G, pos_bits, rid_bits)
    if extend and fits and (G - 1) * total_p <= _PAIRWISE_FUSED_MAX_ROWS \
            and total > 0 and G <= 62:
        seed_len = smls[0].seed_length
        chunk = max(seed_len, 256)
        # padded windows carry the all-ones sentinel key: they form a
        # single not_sent-masked run in the sorted table (can never
        # seed, _unique_occ_flags) and extension never reads them
        # (probes bound by cnts)
        keys_posorder = jnp.concatenate(kp)
        cnts = jnp.asarray(np.array([s.n_windows for s in smls],
                                    np.int32))
        gid, pos = _padded_table_meta(bl, cnts)
        offs = jnp.asarray(np.concatenate(
            [[0], np.cumsum(bl)[:-1]]).astype(np.int32))
        ec = min(extend_capacity, 1 << (max(total, 2) - 1).bit_length())
        while True:
            starts, lengths, valid, _, n_reps = _fused_pairwise_pipeline(
                seed_len, chunk, G, pos_bits, rid_bits, ec,
                repeat_limit, keys_posorder, keys_posorder, gid, pos,
                offs, cnts)
            n_reps = int(n_reps)
            if n_reps <= ec:
                break
            ec = 1 << (n_reps - 1).bit_length()
        v = np.asarray(valid)
        out = MatchArray(np.asarray(starts)[v].astype(np.int64),
                         np.asarray(lengths)[v].astype(np.int64))
        return out.dedup().canonical_sort()
    if extend and total > 0:
        trace.count("host_fallback/pairwise_mums_host")
        warnings.warn(f"find_pairwise_mums: {G} genomes x {total_p} padded "
                      "windows exceed the fused pipeline's packed-word or "
                      "row budget; using the host orchestration",
                      RuntimeWarning, stacklevel=2)
    return _find_pairwise_mums_host(smls, repeat_limit, extend)


def _find_pairwise_mums_host(smls, repeat_limit: int = MER_REPEAT_LIMIT,
                             extend: bool = True) -> MatchArray:
    """Host-orchestrated PairwiseMatchFinder (fetches the whole seed
    table; kept as the fused path's fallback and parity oracle)."""
    G = len(smls)
    content, gid, pos, strand = _seed_table(smls)
    unique_occ, run_id = _unique_occ_flags(content, gid, pos, strand,
                                           repeat_limit)

    uo = np.asarray(unique_occ)
    if not uo.any():
        return MatchArray.empty(G)
    runs = np.asarray(run_id)[uo]
    g = np.asarray(gid)[uo]
    p = np.asarray(pos)[uo].astype(np.int64)
    st = np.asarray(strand)[uo]

    # expand each run's unique occurrences into all genome pairs
    run_change = np.concatenate([[True], runs[1:] != runs[:-1]])
    run_first = np.flatnonzero(run_change)
    run_count = np.diff(np.concatenate([run_first, [len(runs)]]))
    # pair index construction: for each run with k>=2 occurrences, emit
    # all (i, j) with i<j, as global indices into the kept-occurrence list
    ks = run_count
    total = int(((ks * (ks - 1)) // 2).sum())
    if total == 0:
        return MatchArray.empty(G)
    # expand per distinct occurrence-count k (k <= G, so few iterations)
    ai_parts, bi_parts = [], []
    for k in np.unique(ks):
        if k < 2:
            continue
        base = run_first[ks == k]
        ii, jj = np.triu_indices(int(k), 1)
        ai_parts.append((base[:, None] + ii[None, :]).ravel())
        bi_parts.append((base[:, None] + jj[None, :]).ravel())
    a_idx = np.concatenate(ai_parts)
    b_idx = np.concatenate(bi_parts)
    total = len(a_idx)

    starts = np.zeros((total, G), dtype=np.int64)
    sign_b = np.where(st[b_idx] == st[a_idx], 1, -1).astype(np.int64)
    starts[np.arange(total), g[a_idx]] = p[a_idx] + 1
    starts[np.arange(total), g[b_idx]] = sign_b * (p[b_idx] + 1)

    seed_len = smls[0].seed_length
    lengths = np.full((total,), seed_len, dtype=np.int64)
    if extend:
        starts, lengths = _cluster_reduce_np(starts, lengths, seed_len)
        starts, lengths = _extend_rows(smls, starts, lengths)
    return MatchArray(starts, lengths).dedup().canonical_sort()


# --------------------------------------------------------------------------
# host (numpy) pair path — exact twin of the fused pair pipeline
# --------------------------------------------------------------------------

# below this many total seed windows the single-core numpy twin runs
# instead of the device (the recursion/gap-search workloads are
# thousands of sub-100kb fragment pairs, where a device call is mostly
# dispatch and transfer).  Route-only: both paths give the same MUMs.
# The value was tuned on earlier hardware; re-tune it on the GPU.
HOST_PAIR_CUTOFF = int(os.environ.get("LIBMEMS_TPU_HOST_PAIR_CUTOFF",
                                      1 << 16))


def find_pair_mums_np(codes_a: np.ndarray, codes_b: np.ndarray,
                      seed: int, ambig_a: np.ndarray | None = None,
                      ambig_b: np.ndarray | None = None) -> MatchArray:
    """Single-core numpy twin of the fused pair pipeline (identical
    algorithm: pack -> sort -> exact-pair neighbor flags -> diagonal
    cluster sort -> representative compaction -> span-seeded extension
    -> dedup; semantics of MemHash repeat_tolerance=0, MemHash.cpp:
    139-162).  Used for small fragment pairs where device dispatch
    latency dominates, and as bench.py's CPU baseline."""
    from libmems_tpu.ops.mers import canonical_seed_keys_np

    seed_len = seedlib.seed_length(seed)
    km_a = canonical_seed_keys_np(codes_a, seed, ambig_a)
    km_b = canonical_seed_keys_np(codes_b, seed, ambig_b)
    key_sent = np.uint64(~km_a.dtype.type(0))  # masked-window sentinel
    ka = km_a.astype(np.uint64)
    kb = km_b.astype(np.uint64)
    na, nb = len(ka), len(kb)
    if na == 0 or nb == 0:
        return MatchArray.empty(2)
    pb = max(int(max(na, nb)).bit_length(), 8)
    if 2 * seedlib.seed_weight(seed) + 2 + pb > 64:
        # packed word would overflow (same budget as pair_fast_path_ok,
        # minus the gid bit the np path keeps separate): distinct seeds
        # would silently collide — use the general device path instead
        from libmems_tpu.sml import SortedMerList
        return find_mums([SortedMerList.create(codes_a, seed,
                                               ambig=ambig_a),
                          SortedMerList.create(codes_b, seed,
                                               ambig=ambig_b)])

    def pack(keys, gid):
        content = keys >> np.uint64(1)
        strand = keys & np.uint64(1)
        pos = np.arange(len(keys), dtype=np.uint64)
        return (content << np.uint64(pb + 2)) \
            | (np.uint64(gid) << np.uint64(pb + 1)) \
            | (pos << np.uint64(1)) | strand

    w = np.sort(np.concatenate([pack(ka, 0), pack(kb, 1)]))
    c = w >> np.uint64(pb + 2)
    gid = (w >> np.uint64(pb + 1)) & np.uint64(1)
    pos = ((w >> np.uint64(1)) & np.uint64((1 << pb) - 1)).astype(np.int64)
    strand = w & np.uint64(1)
    c1 = np.concatenate([c[1:], [~np.uint64(0)]])
    c2 = np.concatenate([c[2:], [~np.uint64(0)] * 2])
    cp = np.concatenate([[~np.uint64(0)], c[:-1]])
    g1 = np.concatenate([gid[1:], [np.uint64(0)]])
    sent_c = key_sent >> np.uint64(1)
    surv = (c == c1) & (c != cp) & (c1 != c2) & (gid == 0) & (g1 == 1) \
        & (c != sent_c)
    if not surv.any():
        return MatchArray.empty(2)
    posA = pos[surv]
    posB = np.concatenate([pos[1:], [0]])[surv]
    fwd = (strand == np.concatenate([strand[1:], [np.uint64(0)]]))[surv]

    delta = np.where(fwd, posB - posA + (1 << pb), posB + posA)
    order = np.lexsort((posA, delta, ~fwd))
    pA, dl, fw, pB = posA[order], delta[order], fwd[order], posB[order]
    same = np.concatenate([[False], (dl[1:] == dl[:-1])
                           & (fw[1:] == fw[:-1])])
    gap_ok = np.concatenate([[False], pA[1:] - pA[:-1] <= seed_len])
    rep = ~(same & gap_ok)
    rep_idx = np.flatnonzero(rep)
    ends = np.concatenate([rep_idx[1:] - 1, [len(pA) - 1]])
    r_pA, r_pB, r_fw = pA[rep_idx], pB[rep_idx], fw[rep_idx]
    last_pA = pA[ends]
    span = last_pA - r_pA
    lengths = span + seed_len
    leftB = np.where(r_fw, r_pB, dl[rep_idx] - last_pA)

    keys_all = [ka, kb]
    cnts = np.array([na, nb])

    def extend_side(lefts, lengths, side):
        active = np.ones(len(lengths), dtype=bool)
        C0 = 4 * seed_len
        C = C0
        while active.any():
            d = np.arange(1, C + 1)
            ai = np.flatnonzero(active)
            matchm = np.ones((len(ai), C), dtype=bool)
            for g in range(2):
                fwd_g = np.ones(len(ai), bool) if g == 0 else r_fw[ai]
                l = lefts[ai, g]
                back_q = l[:, None] - d[None, :]
                ahead_q = l[:, None] + lengths[ai, None] - seed_len \
                    + d[None, :]
                q = np.where(fwd_g[:, None],
                             back_q if side == 0 else ahead_q,
                             ahead_q if side == 0 else back_q)
                validq = (q >= 0) & (q < cnts[g])
                kq = keys_all[g][np.clip(q, 0, cnts[g] - 1)]
                # masked windows (sentinel ~0, low bit may be parity-
                # flipped below) never match
                validq &= (kq | np.uint64(1)) != (key_sent | np.uint64(1))
                kq = kq ^ fwd_g[:, None].astype(kq.dtype)
                if g == 0:
                    refk = kq
                    refv = validq
                else:
                    matchm &= validq & refv & (kq == refk)
            dm = np.where(matchm, d[None, :], 0)
            pm = np.maximum.accumulate(dm, axis=1)
            pm_excl = np.concatenate(
                [np.zeros((len(ai), 1), np.int64), pm[:, :-1]], axis=1)
            bad = matchm & (d[None, :] - pm_excl > seed_len)
            first_bad = np.where(bad.any(axis=1),
                                 np.argmax(bad, axis=1) + 1, C + 1)
            reach = np.max(np.where(matchm & (d[None, :]
                                              < first_bad[:, None]),
                                    d[None, :], 0), axis=1)
            for g in range(2):
                fwd_g = np.ones(len(ai), bool) if g == 0 else r_fw[ai]
                mv = fwd_g if side == 0 else ~fwd_g
                lefts[ai[mv], g] -= reach[mv]
            lengths[ai] += reach
            active[ai] = reach + seed_len > C
            C = 8 * C0  # survivors are long: escalate the probe window
        return lefts, lengths

    lefts = np.stack([r_pA, leftB], axis=1).astype(np.int64)
    lengths = lengths.astype(np.int64)
    lefts, lengths = extend_side(lefts, lengths, 0)
    lefts, lengths = extend_side(lefts, lengths, 1)
    starts = np.stack([lefts[:, 0] + 1,
                       np.where(r_fw, 1, -1) * (lefts[:, 1] + 1)], axis=1)
    return MatchArray(starts, lengths).dedup().canonical_sort()
