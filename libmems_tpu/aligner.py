"""Flat N-way aligner orchestration (Mauve 1.x pipeline).

Equivalent of Aligner::align (libMems/Aligner.cpp:2193-2286) in its
anchors-only configuration:

  find multi-MUMs -> EliminateOverlaps -> MultiplicityFilter(n) ->
  LCB formation (breakpoint analysis) -> greedy breakpoint elimination
  at a minimum LCB weight -> Interval list (-> XMFA).

The reference's optional stages — recursive inter-anchor re-search
(Recursion, Aligner.cpp:1078), LCB extension (SearchLCBGaps :784), and
MUSCLE gapped alignment (AlignLCBInParallel :1293) — are layered on top:
recursion/gap alignment arrive with the gapped-alignment milestone; with
``gapped_alignment=False`` this matches the reference's
--no-gapped-alignment mode (Aligner.cpp:2275-2276: intervals contain
anchors plus unaligned staircase regions).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from libmems_tpu.distance import distance_matrix
from libmems_tpu.gbe import eliminate_below_weight, surviving_members
from libmems_tpu.interval import Interval, Block, IntervalList, \
    interval_from_matches
from libmems_tpu.lcb import compute_lcb_set, eliminate_overlaps
from libmems_tpu.match import MatchArray
from libmems_tpu.matchfind import find_mums
from libmems_tpu.sequence import Genome
from libmems_tpu.sml import create_smls
from libmems_tpu.tree import TreeNode, midpoint_root, neighbor_joining
from libmems_tpu import seeds as seedlib
from libmems_tpu import trace


@dataclass
class AlignerConfig:
    """Typed configuration for the flat aligner (replaces the setter
    methods on Aligner, libMems/Aligner.h:180-196)."""

    seed: int | None = None           # spaced seed pattern; None = default
    seed_rank: int = 0
    min_lcb_weight: float | None = None  # None = 3 * seed_weight * n
    repeat_tolerance: int = 0
    gapped_alignment: bool = False    # anchors-only when False
    max_gapped_window: int = 10000    # GappedAligner.h:25
    recursive: bool = True            # re-seed inter-anchor gaps
                                      # (Aligner::Recursion, Aligner.cpp:1078)
    min_recursive_gap: int = 32       # skip tiny gaps (DP handles them)
    lcb_extension: bool = True        # search collinear inter-LCB gaps
                                      # (SearchLCBGaps, Aligner.cpp:784)
    collinear: bool = False           # assume no rearrangements: remove
                                      # breakpoints until one LCB remains
                                      # (SimpleBreakpointScorer collinear
                                      # mode, GBE.cpp:877)
    seed_families: int = 1            # >1: union gap-search MUMs over this
                                      # many same-weight seed patterns
                                      # (pairwiseAnchorSearch seed_count=3,
                                      # ProgressiveAligner.cpp:619-651)
    mesh: object | None = None        # jax.sharding.Mesh or device count:
                                      # route MUM discovery through the
                                      # seed-prefix-sharded pipeline
                                      # (parallel.shard.sharded_find_mums)
                                      # — the ParallelMemHash role
                                      # (ParallelMemHash.cpp:42-121):
                                      # same interface, fanned out


def add_unaligned_intervals(intervals: list[Interval],
                            genomes: list[Genome]) -> list[Interval]:
    """Append single-genome intervals covering every base outside all
    LCBs, so the output is a full partition of every genome
    (addUnalignedIntervals, libMems/Aligner.cpp:2284 / Islands.h:318)."""
    G = len(genomes)
    out = list(intervals)
    for g in range(G):
        covered = []
        for iv in intervals:
            le = int(iv.left_ends()[g])
            if le == 0:
                continue
            covered.append((le, int(iv.right_ends()[g])))
        covered.sort()
        cursor = 1
        ranges = []
        for lo, hi in covered:
            if lo > cursor:
                ranges.append((cursor, lo - 1))
            cursor = max(cursor, hi + 1)
        if cursor <= len(genomes[g]):
            ranges.append((cursor, len(genomes[g])))
        for lo, hi in ranges:
            s = np.zeros(G, dtype=np.int64)
            l = np.zeros(G, dtype=np.int64)
            s[g], l[g] = lo, hi - lo + 1
            out.append(Interval(blocks=[Block(s, l)], seq_count=G))
    return out


def _collinear_gap_windows(lcbs, members, mums, genomes):
    """Windows between LCBs that are adjacent in every genome with
    consistent orientation (the search regions of SearchLCBGaps /
    CreateGapSearchList, Aligner.cpp:720-970), plus leading/trailing
    flanks when all genomes agree on their first/last LCB."""
    from libmems_tpu.lcb import find_boundaries
    G = len(genomes)
    bounds = []
    for idx in members:
        le, span, ori = find_boundaries(mums.starts[idx],
                                        mums.lengths[idx])
        bounds.append((le, le + span - 1, ori))
    order = np.argsort([b[0][0] for b in bounds])
    windows = []

    def add_window(gs, gl):
        if (gl > 0).sum() >= 2:
            windows.append((gs, gl))

    # leading flank: before the first LCB of every genome (if consistent)
    for g_end in (False, True):
        gs = np.zeros(G, dtype=np.int64)
        gl = np.zeros(G, dtype=np.int64)
        for g in range(G):
            firsts = sorted(range(len(bounds)),
                            key=lambda i: bounds[i][0][g])
            i = firsts[-1] if g_end else firsts[0]
            le, re, ori = bounds[i]
            if g_end:
                lo, hi = re[g] + 1, len(genomes[g])
            else:
                lo, hi = 1, le[g] - 1
            if hi >= lo:
                gs[g] = lo   # flank frames are forward; inverted flank
                gl[g] = hi - lo + 1  # matches re-enter via new LCBs
        add_window(gs, gl)

    # between genome-0-consecutive LCB pairs adjacent in all genomes
    for a, b in zip(order[:-1], order[1:]):
        le_a, re_a, ori_a = bounds[a]
        le_b, re_b, ori_b = bounds[b]
        gs = np.zeros(G, dtype=np.int64)
        gl = np.zeros(G, dtype=np.int64)
        consistent = True
        rel0 = ori_a[0] == ori_b[0]
        for g in range(G):
            if (ori_a[g] == ori_b[g]) != rel0:
                consistent = False
                break
            lo = min(re_a[g], re_b[g]) + 1
            hi = max(le_a[g], le_b[g]) - 1
            if hi >= lo:
                sign = 1 if ori_a[0] == ori_a[g] else -1
                gs[g] = sign * lo
                gl[g] = hi - lo + 1
        if consistent:
            add_window(gs, gl)
    return windows


def _extend_lcb_anchors(mums: MatchArray, genomes: list[Genome],
                        seed: int, min_weight: float, max_rounds: int = 3,
                        seed_families: int = 1):
    """LCB extension loop (RecursiveAnchorSearch extension rounds,
    Aligner.cpp:1951-2190): search collinear inter-LCB gaps for new
    full-n-way matches, then recompute LCBs + GBE; repeat until no gap
    yields anchors."""
    from libmems_tpu.gbe import eliminate_below_weight as _elim
    from libmems_tpu.gbe import surviving_members as _sm
    from libmems_tpu.lcb import compute_lcb_set as _cls
    from libmems_tpu.recursion import search_gaps_batch
    seq_count = len(genomes)
    lcbs = _cls(mums)
    _elim(lcbs, min_weight)
    members = _sm(lcbs)
    for _ in range(max_rounds):
        # n-way-only masked searches (MaskedMemHash via seq_mask;
        # SearchLCBGaps, Aligner.cpp:2208-2212), batched per round
        jobs = [(gs, gl, seed) for gs, gl in
                _collinear_gap_windows(lcbs, members, mums, genomes)]
        new = []
        for found in search_gaps_batch(genomes, jobs,
                                       seed_families=seed_families,
                                       nway=True):
            found = found.multiplicity_filter(seq_count)
            if len(found):
                new.append(found)
        if not new:
            break
        mums = MatchArray.concat([mums] + new).dedup().canonical_sort()
        lcbs = _cls(mums)
        _elim(lcbs, min_weight)
        members = _sm(lcbs)
    return mums, members


def resolve_mesh(mesh):
    """Accept a Mesh or a device count; None passes through."""
    if mesh is None:
        return None
    from jax.sharding import Mesh
    if isinstance(mesh, Mesh):
        return mesh
    from libmems_tpu.parallel import make_mesh
    return make_mesh(int(mesh))


def _build_index_maybe_multihost(genomes, cfg):
    """SML construction, host-sharded under multi-process execution:
    with cfg.mesh set and jax.process_count() > 1 each process builds
    only its OWNED genomes' indexes and the position-order key tables
    are exchanged once (parallel.multihost; dmSML bin ownership promoted
    to processes).  Single-process: the ordinary threaded build."""
    import jax
    from libmems_tpu.sml import default_seed
    if resolve_mesh(cfg.mesh) is not None and jax.process_count() > 1:
        from libmems_tpu.parallel import multihost as mh
        seed = cfg.seed if cfg.seed is not None else \
            default_seed(genomes, cfg.seed_rank)
        owned = mh.build_owned_smls(genomes, seed)
        return mh.gather_key_tables(owned, len(genomes), seed), seed
    return create_smls(genomes, cfg.seed, cfg.seed_rank)


def _find_mums_maybe_sharded(smls, cfg: AlignerConfig) -> MatchArray:
    """Seed discovery through the single-device fused pipeline or, when
    cfg.mesh is set, the seed-prefix-sharded one — both produce the same
    unique-MUM set (parity-tested, tests/test_sharded_e2e.py), the same
    way ParallelMemHash::FindMatches fed the same aligner as
    MemHash::FindMatches (Aligner.cpp:2193)."""
    mesh = resolve_mesh(cfg.mesh)
    if mesh is None:
        return find_mums(smls, repeat_tolerance=cfg.repeat_tolerance)
    from libmems_tpu.parallel.shard import sharded_find_mums
    return sharded_find_mums(smls, mesh,
                             repeat_tolerance=cfg.repeat_tolerance)


def align(genomes: list[Genome], config: AlignerConfig | None = None
          ) -> tuple[IntervalList, MatchArray]:
    """Run the flat N-way pipeline (Aligner::align, Aligner.cpp:2193-2286);
    returns (intervals, mums)."""
    cfg = config or AlignerConfig()
    seq_count = len(genomes)
    if seq_count < 2:
        raise ValueError("need at least two genomes")

    with trace.stage("sml_build"):
        smls, seed = _build_index_maybe_multihost(genomes, cfg)
    with trace.stage("mum_find"):
        mums = _find_mums_maybe_sharded(smls, cfg)

    # Step 2-3 (Aligner.cpp:2217-2247): overlap trim, then keep only
    # full n-way multi-MUMs
    mums = eliminate_overlaps(mums)
    mums = mums.multiplicity_filter(seq_count)
    if len(mums) == 0:
        return IntervalList([], list(genomes)), mums

    # Step 4-7: LCB formation + greedy elimination at minimum weight
    min_weight = cfg.min_lcb_weight
    if min_weight is None:
        min_weight = 3 * seedlib.seed_weight(seed) * seq_count
    with trace.stage("lcb_gbe"):
        if cfg.collinear:
            from libmems_tpu.gbe import SimpleBreakpointScorer, \
                greedy_breakpoint_elimination
            lcbs = compute_lcb_set(mums)
            scorer = SimpleBreakpointScorer(lcbs, float(min_weight),
                                            collinear=True)
            greedy_breakpoint_elimination(lcbs, scorer)
            members = surviving_members(lcbs)
        elif cfg.lcb_extension:
            mums, members = _extend_lcb_anchors(
                mums, genomes, seed, float(min_weight),
                seed_families=cfg.seed_families)
        else:
            lcbs = compute_lcb_set(mums)
            eliminate_below_weight(lcbs, float(min_weight))
            members = surviving_members(lcbs)

    if not cfg.gapped_alignment:
        intervals = [interval_from_matches(mums, idx) for idx in members]
        return IntervalList(intervals, list(genomes)), mums

    # NJ guide tree from anchor identity (Aligner.cpp:2230-2240) drives
    # both recursion seeding and the MSA merge order
    dm = distance_matrix(mums, [len(g) for g in genomes])
    tree = midpoint_root(neighbor_joining(dm))

    if cfg.recursive:
        from libmems_tpu.recursion import recursive_anchor_fill
        with trace.stage("recursion"):
            mums, members = recursive_anchor_fill(
                mums, members, genomes, seed,
                min_gap=cfg.min_recursive_gap,
                seed_families=cfg.seed_families)

    from libmems_tpu.gapalign import align_lcbs
    with trace.stage("gapped_align"):
        intervals = align_lcbs(mums, members, genomes, tree,
                               max_window=cfg.max_gapped_window)
    with trace.stage("unaligned_intervals"):
        intervals = add_unaligned_intervals(intervals, genomes)
    return IntervalList(intervals, list(genomes)), mums
