"""Measured wall-clock bounds for the host-side sequential sweeps on
adversarial (repeat-rich / overlap-dense) inputs.

The overlap-elimination interior (`lcb._sweep_overlap_cluster`) is the
reference's sequential trim sweep (Aligner.cpp:62-178) run only inside
overlap clusters; its practical bound comes from deletion pressure —
every inner comparison either breaks out (sorted non-overlap), deletes
a match, or trims one smaller, so clusters collapse instead of going
quadratic.  These tests PIN that behavior with generous budgets
(measured values were 100-1000x smaller on a 2-CPU box): a future
change that re-introduces a quadratic interior fails loudly here.
"""

import time

import numpy as np
import pytest

from libmems_tpu.lcb import eliminate_overlaps
from libmems_tpu.match import MatchArray
from libmems_tpu.matchfind import _containment_filter


def test_dense_single_cluster_budget():
    """1500 matches all overlapping in one genome-0 window (measured
    0.02 s)."""
    K = 1500
    rng = np.random.default_rng(0)
    starts = np.zeros((K, 2), dtype=np.int64)
    starts[:, 0] = 1 + rng.integers(0, 400, K)
    starts[:, 1] = 1 + np.arange(K) * 1000
    lens = 200 + rng.integers(0, 400, K).astype(np.int64)
    t0 = time.perf_counter()
    out = eliminate_overlaps(MatchArray(starts, lens))
    assert time.perf_counter() - t0 < 10.0
    # survivors must be overlap-free in genome 0
    s = np.abs(out.starts[:, 0])
    order = np.argsort(s)
    ends = s[order] + out.lengths[order] - 1
    assert (s[order][1:] > ends[:-1]).all()


def test_nested_overlap_stress_budget():
    """4000 matches: window-spanning giants + staggered smalls, all in
    one overlap cluster (measured 0.03 s)."""
    K = 4000
    starts = np.zeros((K, 2), dtype=np.int64)
    lens = np.zeros(K, dtype=np.int64)
    for i in range(K):
        if i % 4 == 0:
            starts[i, 0] = 1 + (i % 16)
            lens[i] = 50000 - (i % 16) * 7
        else:
            starts[i, 0] = 1 + (i * 13) % 48000
            lens[i] = 60 + (i * 7) % 500
        starts[i, 1] = 1 + i * 60001
    t0 = time.perf_counter()
    out = eliminate_overlaps(MatchArray(starts, lens))
    assert time.perf_counter() - t0 < 10.0
    assert len(out) >= 1


def test_containment_filter_budget():
    """200k matches stacked on one diagonal (measured 0.19 s; the
    filter interior is array-native — lexsort + prefix max)."""
    K = 200_000
    rng = np.random.default_rng(2)
    starts = np.zeros((K, 2), dtype=np.int64)
    base = rng.integers(1, 10**6, K)
    starts[:, 0] = base
    starts[:, 1] = base + 500
    lens = rng.integers(20, 2000, K).astype(np.int64)
    t0 = time.perf_counter()
    ks, kl = _containment_filter(starts, lens)
    assert time.perf_counter() - t0 < 15.0
    assert 0 < len(kl) < K


@pytest.mark.slow
def test_repeat_rich_pair_end_to_end_budget():
    """60 diverged copies of a 1 kb unit with random spacers, aligned
    pairwise: the 1000-repeat cutoff + per-genome-unique seed rule keep
    enumeration bounded and the sweep input small (measured 16.5 s on a
    2-CPU box, mostly device dispatch)."""
    from libmems_tpu import seeds as seedlib
    from libmems_tpu.matchfind import find_pairwise_mums
    from libmems_tpu.sml import SortedMerList

    rng = np.random.default_rng(0)
    unit = rng.integers(0, 4, size=1000).astype(np.uint8)

    def mut(x, p):
        y = x.copy()
        idx = rng.random(len(y)) < p
        y[idx] = rng.integers(0, 4, size=int(idx.sum())).astype(np.uint8)
        return y

    parts = []
    for _ in range(60):
        parts.append(mut(unit, 0.02))
        parts.append(rng.integers(0, 4, size=500).astype(np.uint8))
    a = np.concatenate(parts)
    b = mut(a, 0.01)
    seed = seedlib.get_seed(11, 0)
    smls = [SortedMerList.create(a, seed), SortedMerList.create(b, seed)]
    t0 = time.perf_counter()
    ma = find_pairwise_mums(smls)
    out = eliminate_overlaps(ma)
    assert time.perf_counter() - t0 < 300.0
    assert len(out) > 0
