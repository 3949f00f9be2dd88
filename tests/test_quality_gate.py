"""Alignment-content quality gate.

Byte-goldens catch drift but regenerate on any intentional change; this
gate tracks CONTENT quality with tolerant thresholds instead, so a
change that silently degrades alignment quality (profile-DP
approximation, refinement regression, anchor-selection bug) fails even
after goldens are regenerated.  Metrics: sum-of-pairs score
(computeSPScore analog) and multi-aligned base coverage of the final
IntervalList (scoring.alignment_quality_stats).

Thresholds are floors/relations, not pins.  Scales are sized for the
CPU test mesh (refine windows here stay small); chip_smoke.py applies
the same floors at production scale on the GPU and bench_e2e.py tracks
the metrics there.
"""

import os

import numpy as np
import pytest

from libmems_tpu.scoring import alignment_quality_stats
from libmems_tpu.sequence import Genome

pytestmark = pytest.mark.slow

_LUT = np.frombuffer(b"ACGT", dtype=np.uint8)
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _family(rng, n, length, mutate=0.02):
    anc = rng.integers(0, 4, size=length).astype(np.uint8)
    out = []
    for i in range(n):
        g = anc.copy()
        idx = rng.random(length) < mutate
        g[idx] = rng.integers(0, 4, size=int(idx.sum())).astype(np.uint8)
        out.append(Genome(name=f"g{i}", ascii=_LUT[g], codes=g))
    return out


def test_pair_config_quality_floor():
    """Scaled golden config 1/3: 60 kb 1%-divergent pair with one
    inversion.  Floors are measured-minus-margin:
    r5 measured frac 1.000, SP 5.62e6 (93.7*n), core 59954 (0.999*n) —
    floors sit ~10% under so a real regression (halved SP, dropped
    coverage) fails while content-neutral changes pass."""
    from tests.golden import generate
    from libmems_tpu.aligner import AlignerConfig, align

    gs = generate._genomes_pair()
    ivs, _ = align(gs, AlignerConfig(gapped_alignment=True))
    q = alignment_quality_stats(ivs)
    n = len(gs[0])
    assert q["multi_aligned_base_frac"] > 0.99, q
    assert q["sp_score"] > 84 * n, q          # measured 93.7*n
    assert q["core_columns"] > 0.97 * n, q    # measured 0.999*n


def test_progressive_quality_floor():
    """5-genome 2%-divergent family, no refine (fast)."""
    from libmems_tpu.progressive import ProgressiveConfig, \
        progressive_align

    gs = _family(np.random.default_rng(11), 5, 6000)
    ivs, _ = progressive_align(gs, ProgressiveConfig(refine=False))
    q = alignment_quality_stats(ivs)
    # r5 measured: frac 0.9995, SP 5.39e6 (899*n at G=5), core 5993
    assert q["multi_aligned_base_frac"] > 0.98, q
    assert q["core_columns"] > 0.95 * 6000, q
    assert q["sp_score"] > 0.8 * 5_390_000, q


def test_repeat_rich_quality_floor():
    """Planted-repeat-family pair: IS-element-like
    multi-copy families stress the 1000-occurrence cutoff, overlap
    clustering and uniqueness-scaled anchor scores.  Floors from the r5
    measurement at this scale (frac ~0.99+, core ~0.97n) minus margin."""
    import sys
    sys.path.insert(0, REPO_ROOT)
    try:
        from bench_e2e import repeat_rich_pair
    finally:
        sys.path.remove(REPO_ROOT)
    from libmems_tpu.aligner import AlignerConfig, align

    a, b = repeat_rich_pair(length=120_000)
    gs = [Genome(name="A", ascii=_LUT[a], codes=a),
          Genome(name="B", ascii=_LUT[b], codes=b)]
    ivs, mums = align(gs, AlignerConfig(gapped_alignment=True,
                                        recursive=False))
    q = alignment_quality_stats(ivs)
    n = len(a)
    assert q["multi_aligned_base_frac"] > 0.95, q
    assert q["core_columns"] > 0.90 * n, q
    assert q["sp_score"] > 70 * n, q
    assert len(mums) > 20      # repeats fragment the MUM set


def test_refine_never_regresses_sp():
    """Refinement accepts a window only when its SP improves, so the
    refined alignment's SP must not regress (quantifies what
    refineAlignment buys; PA.cpp:1118).  Small windows: CPU DP."""
    from libmems_tpu.progressive import ProgressiveConfig, \
        progressive_align

    gs = _family(np.random.default_rng(12), 4, 1500, mutate=0.05)
    ivs_off, _ = progressive_align(gs, ProgressiveConfig(refine=False))
    ivs_on, _ = progressive_align(gs, ProgressiveConfig(refine=True))
    q_off = alignment_quality_stats(ivs_off)
    q_on = alignment_quality_stats(ivs_on)
    assert q_on["sp_score"] >= q_off["sp_score"] * 0.999, (q_on, q_off)
