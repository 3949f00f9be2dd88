"""Seed occurrence frequencies + uniqueness-scaled anchor scoring.

Equivalents of:

* SeedOccurrenceList (libMems/SeedOccurrenceList.h:22-92): per-position
  seed frequency = the SML run length of the seed starting at that
  position, then a trailing-window mean over seed_length positions
  ("average frequency of all k-mers containing the position"), floor 1;
* GetPairwiseAnchorScore (libMems/GreedyBreakpointElimination.h:403-474)
  with the reference defaults (penalize_gaps for gapped chunks only,
  penalize_repeats=false, GBE.cpp:37): per column, HOXD70 substitution
  score between the oriented characters, positive scores divided by the
  product of the two genomes' seed frequencies at the column's
  forward-strand offsets from the match left ends.

Both are flat vector passes (run-length scatter + sliding mean; gather +
segment-sum), computed here with numpy over the whole match set at once —
the shapes are data-dependent and the arithmetic is memory-bound, so the
win comes from vectorization, not matrix units.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from libmems_tpu import seeds as seedlib
from libmems_tpu.match import MatchArray, NO_MATCH
from libmems_tpu.ops.gapped import HOXD70
from libmems_tpu.sml import SortedMerList


@functools.partial(jax.jit, static_argnums=(3, 4))
def _seed_occurrence_device(sorted_keys, sorted_positions, real_len,
                            total_len: int, seed_len: int):
    """Device seed-occurrence construction: run lengths over the sorted
    keys, reorder to position order with one payload sort (sorts
    replace scatters throughout the pipeline, PERF.md), then the
    trailing-mean smoothing as a cumsum.  Only float32[total_len] ever
    leaves the device — a third of the bytes of fetching the (keys,
    positions) table."""
    from libmems_tpu.ops import segments as seg

    sc = seg.run_starts(sorted_keys >> 1)
    runlen = seg.run_lengths(sc).astype(jnp.int32)
    # sentinel windows (bucket padding and ambiguity-masked windows)
    # count as frequency 1: they participate in no matches, and pad
    # counts must not bleed into the trailing-mean smoothing of real
    # tail positions
    runlen = jnp.where(sorted_keys == ~jnp.zeros((), sorted_keys.dtype),
                       1, runlen)
    # position-order counts: sort (position, runlen); positions are a
    # permutation of [0, n)
    _, count_posorder = jax.lax.sort(
        (sorted_positions, runlen), num_keys=1, is_stable=False)
    n = sorted_keys.shape[0]
    count = jnp.ones((total_len,), jnp.int32).at[:n].set(count_posorder)

    if total_len > 1 and seed_len > 0:
        # exact integer prefix sum: a float32 cumsum loses integer
        # precision past ~2^24 (≥16 Mbp genomes) and the windowed
        # difference csum[i+s]-csum[i] then cancels catastrophically
        padded = jnp.concatenate(
            [jnp.ones((seed_len - 1,), jnp.int32), count])
        csum = jnp.concatenate([jnp.zeros((1,), jnp.int64),
                                jnp.cumsum(padded.astype(jnp.int64))])
        smoothed = ((csum[seed_len:] - csum[:-seed_len])
                    .astype(jnp.float32) / seed_len)
        countf = jnp.concatenate([smoothed[:-1],
                                  count[-1:].astype(jnp.float32)])
        # the genome's true final position keeps its RAW count —
        # SeedOccurrenceList::smoothFrequencies never overwrites
        # count[Length-1] (SeedOccurrenceList.h:76-92); with bucket
        # padding the `count[-1:]` special case above lands on a pad
        # position, so restore the raw count at real_len-1 explicitly
        # (real_len is traced: genomes of different true lengths share
        # one executable)
        last = jnp.clip(real_len - 1, 0, total_len - 1)
        raw_last = jax.lax.dynamic_slice(count, (last,),
                                         (1,)).astype(jnp.float32)
        countf = jax.lax.dynamic_update_slice(countf, raw_last, (last,))
    else:
        countf = count.astype(jnp.float32)
    return jnp.maximum(countf, 1.0)


def _padded_occurrence_inputs(sml: SortedMerList):
    from libmems_tpu.sml import _bucket_len
    n = sml.n_windows
    npad = _bucket_len(n)
    lpad = npad + (sml.length - n)
    if npad == n:
        return sml.sorted_keys, sml.sorted_positions, lpad
    sent = ~jnp.zeros((), sml.sorted_keys.dtype)
    keys = jnp.concatenate([
        sml.sorted_keys, jnp.full((npad - n,), sent,
                                  sml.sorted_keys.dtype)])
    spos = jnp.concatenate([
        sml.sorted_positions,
        jnp.arange(n, npad, dtype=sml.sorted_positions.dtype)])
    return keys, spos, lpad


def seed_occurrence_list(sml: SortedMerList) -> np.ndarray:
    """float32[genome_length] smoothed per-position seed frequency
    (SeedOccurrenceList::construct + smoothFrequencies,
    libMems/SeedOccurrenceList.h:22-92).

    Inputs are bucket-padded so genomes of different lengths share one
    compiled executable (compiles dominate small-shape-variation
    workloads).  Pad windows carry the all-ones
    sentinel key — a trailing run whose counts only affect pad
    positions, sliced off before return."""
    n = sml.n_windows
    if n == 0:
        return np.ones(sml.length, dtype=np.float32)
    keys, spos, lpad = _padded_occurrence_inputs(sml)
    out = np.asarray(_seed_occurrence_device(
        keys, spos, jnp.int32(sml.length), lpad, sml.seed_length))
    return np.ascontiguousarray(out[:sml.length])


def _smooth_counts_np(count: np.ndarray, seed_len: int) -> np.ndarray:
    """Numpy mirror of the trailing-mean smoothing in
    _seed_occurrence_device (identical op order, so float32 results are
    bit-equal to the device path)."""
    total_len = count.shape[0]
    if total_len > 1 and seed_len > 0:
        padded = np.concatenate(
            [np.ones(seed_len - 1, np.int32), count])
        csum = np.concatenate([np.zeros(1, np.int64),
                               np.cumsum(padded, dtype=np.int64)])
        smoothed = ((csum[seed_len:] - csum[:-seed_len])
                    .astype(np.float32) / seed_len)
        countf = np.concatenate([smoothed[:-1],
                                 count[-1:].astype(np.float32)])
    else:
        countf = count.astype(np.float32)
    return np.maximum(countf, np.float32(1.0))


def seed_occurrence_list_np(genome, seed: int) -> np.ndarray:
    """Host numpy twin of seed_occurrence_list, computed from the genome
    itself (no SML fetch).  Bit-equal to the device path: same run-length
    counts, same int64 prefix-sum smoothing, same float32 division.

    Exists because at small-genome scale the device path's cost is
    dominated by a compile or executable load per shape plus the
    float32[L] fetch, not by compute (PERF.md rule 12)."""
    from libmems_tpu.ops.mers import canonical_seed_keys_np
    from libmems_tpu.sequence import Genome

    seed_len = seedlib.seed_length(seed)
    if isinstance(genome, Genome):
        codes = genome.codes
        a = genome.ambig
        ambig = a if a.any() else None
        if genome.circular:
            # circular wrap, as SortedMerList.create (SortedMerList
            # .cpp:797-800)
            codes = np.concatenate([codes, codes[: seed_len - 1]])
            if ambig is not None:
                ambig = np.concatenate([ambig, ambig[: seed_len - 1]])
            length = len(codes) - (seed_len - 1)
        else:
            length = len(codes)
    else:
        codes = np.asarray(genome, dtype=np.uint8)
        ambig = None
        length = len(codes)

    keys = canonical_seed_keys_np(codes, seed, ambig)
    n = keys.shape[0]
    if n == 0:
        return np.ones(length, dtype=np.float32)
    content = keys >> np.uint8(1)
    order = np.argsort(content, kind="stable")
    sc = content[order]
    run_start = np.empty(n, dtype=bool)
    run_start[0] = True
    np.not_equal(sc[1:], sc[:-1], out=run_start[1:])
    run_id = np.cumsum(run_start) - 1
    runlen = np.bincount(run_id).astype(np.int32)
    cnt_sorted = runlen[run_id]
    sentinel = ~keys.dtype.type(0)
    cnt_sorted = np.where(keys[order] == sentinel, np.int32(1),
                          cnt_sorted)
    count = np.ones(length, dtype=np.int32)
    count_pos = np.empty(n, dtype=np.int32)
    count_pos[order] = cnt_sorted
    count[:n] = count_pos
    return _smooth_counts_np(count, seed_len)


# device-path threshold: below this many seed windows per genome the
# host twin is used (the device path pays a compile or executable load
# per shape plus a float32[L] fetch per genome; the host twin is one
# argsort).  Output-neutral: both paths are bit-equal.  The value was
# tuned on earlier hardware; re-tune it on the GPU (ROADMAP).  0
# disables the host twin entirely.
import os as _os

SOL_HOST_MAX = int(_os.environ.get("LIBMEMS_TPU_SOL_HOST_MAX", 8_000_000))


@functools.partial(jax.jit, static_argnums=(3, 4))
def _seed_occurrence_batch(keys_b, spos_b, real_len_b, total_len: int,
                           seed_len: int):
    return jax.vmap(lambda k, p, rl: _seed_occurrence_device.__wrapped__(
        k, p, rl, total_len, seed_len))(keys_b, spos_b, real_len_b)


def seed_occurrence_lists(smls: list[SortedMerList],
                          genomes: list | None = None
                          ) -> list[np.ndarray]:
    """Batched seed_occurrence_list over many genomes: genomes sharing
    a padded bucket shape run as ONE vmapped dispatch + fetch (a
    per-genome loop pays dispatch/fetch overhead x G).

    When `genomes` is given, genomes under SOL_HOST_MAX seed windows run
    the bit-equal host twin instead (seed_occurrence_list_np) — at small
    scale the device path cost is executable load + fetch, not compute."""
    out: list = [None] * len(smls)
    if genomes is not None and SOL_HOST_MAX > 0:
        rest_smls, rest_idx = [], []
        for i, s in enumerate(smls):
            if 0 < s.n_windows <= SOL_HOST_MAX:
                out[i] = seed_occurrence_list_np(genomes[i], s.seed)
            else:
                rest_smls.append(s)
                rest_idx.append(i)
        if rest_smls:
            for j, r in zip(rest_idx, seed_occurrence_lists(rest_smls)):
                out[j] = r
        return out
    groups: dict[tuple[int, int, int], list[int]] = {}
    for i, s in enumerate(smls):
        if s.n_windows == 0:
            out[i] = np.ones(s.length, dtype=np.float32)
            continue
        keys, spos, lpad = _padded_occurrence_inputs(s)
        groups.setdefault((int(keys.shape[0]), lpad, s.seed_length),
                          []).append((i, keys, spos))
    for (npad, lpad, seed_len), members in groups.items():
        if len(members) == 1:
            i, keys, spos = members[0]
            res = np.asarray(_seed_occurrence_device(
                keys, spos, jnp.int32(smls[i].length), lpad, seed_len))
            out[i] = np.ascontiguousarray(res[:smls[i].length])
            continue
        keys_b = jnp.stack([m[1] for m in members])
        spos_b = jnp.stack([m[2] for m in members])
        lens_b = jnp.asarray(
            np.array([smls[m[0]].length for m in members], np.int32))
        res = np.asarray(_seed_occurrence_batch(keys_b, spos_b, lens_b,
                                                lpad, seed_len))
        for r, (i, _, _) in enumerate(members):
            out[i] = np.ascontiguousarray(res[r, :smls[i].length])
    return out


def pairwise_anchor_scores(matches: MatchArray, gi: int, gj: int,
                           codes: list[np.ndarray],
                           sols: list[np.ndarray]) -> np.ndarray:
    """Per-match uniqueness-scaled substitution score between genomes
    gi and gj (GetPairwiseAnchorScore over ungapped matches).

    Matches not including both genomes score 0.  codes[g] are 2-bit
    genome codes; sols[g] the seed-occurrence arrays.
    """
    n = len(matches)
    out = np.zeros(n, dtype=np.float64)
    si = matches.starts[:, gi]
    sj = matches.starts[:, gj]
    sel = (si != NO_MATCH) & (sj != NO_MATCH)
    if not sel.any():
        return out
    idx = np.flatnonzero(sel)
    L = matches.lengths[idx]
    si, sj = si[idx], sj[idx]

    total = int(L.sum())
    mid = np.repeat(np.arange(len(idx)), L)
    starts_flat = np.concatenate([[0], np.cumsum(L)[:-1]])
    col = np.arange(total) - starts_flat[mid]

    def oriented(codes_g, s, lens):
        le = np.abs(s) - 1
        fwd = s > 0
        pos = np.where(fwd[mid], le[mid] + col,
                       le[mid] + lens[mid] - 1 - col)
        c = codes_g[pos]
        return np.where(fwd[mid], c, 3 - c)

    ci = oriented(codes[gi], si, L)
    cj = oriented(codes[gj], sj, L)
    sub = HOXD70[ci, cj].astype(np.float64)

    lei = (np.abs(si) - 1)[mid] + col
    lej = (np.abs(sj) - 1)[mid] + col
    uni = sols[gi][np.minimum(lei, len(sols[gi]) - 1)].astype(np.float64) \
        * sols[gj][np.minimum(lej, len(sols[gj]) - 1)].astype(np.float64)
    uni = np.maximum(uni, 1.0)
    scaled = np.where(sub > 0, sub / uni, sub)
    np.add.at(out, idx[mid], scaled)
    return out


def sum_of_pairs_anchor_scores(matches: MatchArray,
                               codes: list[np.ndarray],
                               sols: list[np.ndarray],
                               pairs: list[tuple[int, int]] | None = None
                               ) -> np.ndarray:
    """Σ over genome pairs of pairwise anchor scores (the progressive
    aligner's tm_score_array collapsed over its pair axes,
    ProgressiveAligner::pairwiseScoreTrackingMatches, PA.cpp:1790)."""
    G = matches.seq_count
    if pairs is None:
        pairs = [(i, j) for i in range(G) for j in range(i + 1, G)]
    total = np.zeros(len(matches), dtype=np.float64)
    for i, j in pairs:
        total += pairwise_anchor_scores(matches, i, j, codes, sols)
    return total
