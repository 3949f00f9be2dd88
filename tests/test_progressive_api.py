"""Progressive public-surface additions:
align_profiles (alignPP analog, PA.cpp:3569), ProgressiveConfig.collinear
(setCollinearGenomes, ProgressiveAligner.h:80) and scoring_scheme
(LcbScoringScheme, ProgressiveAligner.h:89-94)."""

import numpy as np
import pytest

from libmems_tpu.progressive import (ProgressiveConfig, align_nodes,
                                     align_profiles,
                                     node_alignment_from_intervals,
                                     progressive_align)
from libmems_tpu.sequence import Genome

ALPHA = np.array(list("ACGT"))


def _family(rng, n, length=6000, invert=False):
    anc = rng.integers(0, 4, length).astype(np.uint8)
    out = []
    for k in range(n):
        g = anc.copy()
        idx = rng.random(length) < 0.01
        g[idx] = rng.integers(0, 4, int(idx.sum()))
        if invert and k == n - 1:
            a, b = length // 3, 2 * length // 3
            g = np.concatenate([g[:a], (3 - g[a:b])[::-1], g[b:]])
        out.append(Genome.from_string("".join(ALPHA[g])))
    return out


def test_align_profiles_roundtrip():
    """align_profiles of two 2-genome profiles equals align_nodes on the
    same NodeAlignments + the extraction path — and preserves the
    within-profile columns."""
    rng = np.random.default_rng(3)
    fam = _family(rng, 4)
    g12, g34 = fam[:2], fam[2:]
    cfg2 = ProgressiveConfig(refine=False, gap_search=False,
                             use_bp_distance=False)
    ivs1, _ = progressive_align(g12, cfg2)
    ivs2, _ = progressive_align(g34, cfg2)

    cfg = ProgressiveConfig(refine=False, gap_search=False)
    merged = align_profiles(ivs1, g12, ivs2, g34, cfg)
    assert merged.genomes is not None and len(merged.genomes) == 4
    rows_sets = [iv.blocks[0].rows if iv.blocks else None
                 for iv in merged.intervals]
    # every genome is covered end to end
    from libmems_tpu.validate import validate_interval_list
    validate_interval_list(merged, fam)
    # at least one interval aligns all four rows
    full = [iv for iv in merged.intervals
            if (iv.starts() != 0).sum() == 4]
    assert full, "no 4-way interval produced"
    # within-profile columns preserved: genomes 0,1 stay aligned to
    # each other wherever they were before (compare aligned-pair base
    # fraction does not decrease)
    def pair_cols(ivs, r0, r1):
        total = 0
        for iv in ivs.intervals:
            if (iv.starts() == 0).any():
                continue
            for b in iv.blocks:
                total += int(((b.rows[r0] != ord("-"))
                              & (b.rows[r1] != ord("-"))).sum())
        return total
    # ivs1 rows 0,1 <-> merged rows 0,1
    n_before = 0
    for iv in ivs1.intervals:
        if (iv.starts() == 0).any():
            continue
        for b in iv.blocks:
            n_before += int(((b.rows[0] != ord("-"))
                             & (b.rows[1] != ord("-"))).sum())
    n_after = 0
    for iv in merged.intervals:
        s = iv.starts()
        if s[0] == 0 or s[1] == 0:
            continue
        for b in iv.blocks:
            n_after += int(((b.rows[0] != ord("-"))
                            & (b.rows[1] != ord("-"))).sum())
    assert n_after >= n_before


def test_node_alignment_from_intervals_roundtrip():
    rng = np.random.default_rng(9)
    fam = _family(rng, 2)
    cfg = ProgressiveConfig(refine=False, gap_search=False,
                            use_bp_distance=False)
    ivs, _ = progressive_align(fam, cfg)
    na = node_alignment_from_intervals(ivs, [0, 1])
    assert na.leaf_ids == [0, 1]
    covered = sum(int(b.lengths()[0]) for b in na.blocks
                  if b.starts[0] != 0)
    assert covered == len(fam[0])


def test_collinear_single_lcb():
    """collinear=True on a rearrangement-free family: one interval
    spanning both genomes (no breakpoints introduced); on an INVERTED
    family the flag still yields a single aligned chain (the inversion
    is left unaligned rather than split into LCBs)."""
    rng = np.random.default_rng(5)
    fam = _family(rng, 2)
    cfg = ProgressiveConfig(refine=False, gap_search=False,
                            use_bp_distance=False, collinear=True)
    ivs, _ = progressive_align(fam, cfg)
    multi = [iv for iv in ivs.intervals if (iv.starts() != 0).sum() == 2]
    assert len(multi) == 1

    # 5 kb inversion in a 15 kb genome: big enough that free mode keeps
    # it as its own (inverted) LCB
    fam_inv = _family(rng, 2, length=15000, invert=True)
    ivs_inv, _ = progressive_align(fam_inv, cfg)
    multi_inv = [iv for iv in ivs_inv.intervals
                 if (iv.starts() != 0).sum() == 2]
    assert len(multi_inv) == 1
    assert (multi_inv[0].starts() > 0).all()    # single forward chain
    # without the flag the inversion forms its own (inverted) LCB
    cfg_free = ProgressiveConfig(refine=False, gap_search=False,
                                 use_bp_distance=False)
    ivs_free, _ = progressive_align(fam_inv, cfg_free)
    multi_free = [iv for iv in ivs_free.intervals
                  if (iv.starts() != 0).sum() == 2]
    assert len(multi_free) > 1
    assert any((iv.starts() < 0).any() for iv in multi_free)


def test_ancestral_scoring_scheme_runs():
    rng = np.random.default_rng(7)
    fam = _family(rng, 3, invert=True)
    cfg = ProgressiveConfig(refine=False, gap_search=False,
                            use_bp_distance=False,
                            scoring_scheme="ancestral")
    ivs, _ = progressive_align(fam, cfg)
    from libmems_tpu.validate import validate_interval_list
    validate_interval_list(ivs, fam)
    multi = [iv for iv in ivs.intervals if (iv.starts() != 0).sum() >= 2]
    assert multi
    with pytest.raises(ValueError, match="scoring_scheme"):
        progressive_align(fam, ProgressiveConfig(
            refine=False, scoring_scheme="bogus"))
