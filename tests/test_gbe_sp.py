"""Sum-of-pairs scored GBE: incremental scorer vs brute-force recompute.

Parity targets:
* scorer.score() equals a from-scratch recomputation of the objective;
* every move_score equals the score change actually observed when the
  move is applied to a deep copy (no-copy probe == copy-probe);
* probe moves leave the structure bit-identical (journal undo);
* greedy_search on the incremental scorer equals greedy_search on a
  deep-copy-probing reference implementation.
"""

import copy

import numpy as np
import pytest

from libmems_tpu.gbe_sp import (SumOfPairsBreakpointScorer, greedy_search,
                                scaled_breakpoint_penalties)
from libmems_tpu.match import MatchArray


def random_tracking_matches(rng, G=4, n=40, coord=10_000):
    """Random pairwise matches: each match spans one genome pair with
    random positions/orientations/lengths."""
    starts = np.zeros((n, G), dtype=np.int64)
    lengths = rng.integers(20, 200, size=n).astype(np.int64)
    pair_of = []
    for i in range(n):
        gi, gj = sorted(rng.choice(G, size=2, replace=False))
        si = rng.integers(1, coord)
        sj = rng.integers(1, coord)
        starts[i, gi] = si
        starts[i, gj] = sj * (1 if rng.random() < 0.7 else -1)
        pair_of.append((gi, gj))
    pairs = [(i, j) for i in range(G) for j in range(i + 1, G)]
    tm = np.zeros((n, len(pairs)), dtype=np.float64)
    for i, pij in enumerate(pair_of):
        tm[i, pairs.index(pij)] = rng.uniform(10, 500)
    return MatchArray(starts, lengths), tm, pairs


def brute_score(scorer):
    """Objective recomputed from the scorer's current structure."""
    total = 0.0
    for p in range(len(scorer.pairs)):
        st = scorer.sets[p]
        alive = st.lcb_id == np.arange(st.n)
        w = float(st.weight[alive].sum())
        total += w - scorer.penalties[p] * (int(alive.sum()) - 1)
    return total


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_score_matches_brute(seed):
    rng = np.random.default_rng(seed)
    m, tm, pairs = random_tracking_matches(rng)
    sc = SumOfPairsBreakpointScorer(m, tm, pairs, penalties=100.0)
    assert np.isclose(sc.score(), brute_score(sc))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_move_score_equals_applied_diff_and_probe_is_pure(seed):
    rng = np.random.default_rng(seed)
    m, tm, pairs = random_tracking_matches(rng, n=30)
    sc = SumOfPairsBreakpointScorer(m, tm, pairs, penalties=150.0)

    def snapshot(s):
        return ([(x.left_end.copy(), x.right_end.copy(),
                  x.left_adjacency.copy(), x.right_adjacency.copy(),
                  x.lcb_id.copy(), x.weight.copy()) for x in s.sets],
                s.tm_lcb_id.copy(), [list(map(list, mm)) for mm in s.members],
                s.pair_score.copy(), s.pair_count.copy())

    for move in range(sc.move_count()):
        before = snapshot(sc)
        d = sc.move_score(move)
        after = snapshot(sc)
        # probe must not mutate anything
        for b, a in zip(before[0], after[0]):
            for x, y in zip(b, a):
                assert np.array_equal(x, y)
        assert np.array_equal(before[1], after[1])
        assert before[2] == after[2]
        if d is None:
            continue
        # applying the move on a deep copy must change score by exactly d
        sc2 = copy.deepcopy(sc)
        s0 = sc2.score()
        assert sc2.remove(move) is not None
        assert np.isclose(sc2.score() - s0, d), (move, d, sc2.score() - s0)
        assert np.isclose(sc2.score(), brute_score(sc2))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_greedy_search_improves_and_stays_consistent(seed):
    rng = np.random.default_rng(seed)
    m, tm, pairs = random_tracking_matches(rng, G=3, n=50)
    sc = SumOfPairsBreakpointScorer(m, tm, pairs, penalties=200.0)
    s0 = sc.score()
    s1 = greedy_search(sc)
    assert s1 >= s0 - 1e-9
    assert np.isclose(s1, brute_score(sc))
    # surviving matches' pairwise scores are consistent with pair_score
    surv = sc.results()
    for p in range(len(pairs)):
        alive_ids = sc.tm_lcb_id[surv, p]
        keep = alive_ids != -1
        assert np.isclose(sc.pair_score[p], tm[surv[keep], p].sum())


def test_penalty_scaling_formula():
    pen = scaled_breakpoint_penalties(
        7000.0, 100.0, np.array([0.5]), np.array([0.2]))
    expect = max(7000.0 * ((1 - 0.2) ** 4) * ((1 - 0.5) ** 2), 100.0)
    assert np.isclose(pen[0], expect)


def test_high_penalty_collapses_low_scores():
    """With a huge penalty every low-scoring isolated LCB is removed."""
    rng = np.random.default_rng(7)
    m, tm, pairs = random_tracking_matches(rng, G=3, n=30)
    sc = SumOfPairsBreakpointScorer(m, tm, pairs, penalties=1e9)
    greedy_search(sc)
    # at most one LCB should remain per pair (removing the last LCB of a
    # pair gains penalty only when another pair still pays one)
    assert all(c <= 1 for c in sc.pair_count)


def test_seed_occurrence_lists_batched_parity():
    """Batched (vmapped) seed-occurrence construction must equal the
    per-genome path for mixed bucket shapes."""
    import numpy as np
    from libmems_tpu import seeds
    from libmems_tpu.anchorscore import (seed_occurrence_list,
                                         seed_occurrence_lists)
    from libmems_tpu.sml import SortedMerList

    rng = np.random.default_rng(7)
    smls = [SortedMerList.create(
        rng.integers(0, 4, n).astype(np.uint8), seeds.get_seed(11, 0))
        for n in (4000, 4100, 7000, 4050)]
    batched = seed_occurrence_lists(smls)
    for s, b in zip(smls, batched):
        np.testing.assert_array_equal(seed_occurrence_list(s), b)


def test_seed_occurrence_host_twin_parity():
    """seed_occurrence_list_np (host twin) must be bit-equal to the
    device path, including ambiguity-masked windows and circular wrap."""
    import numpy as np
    from libmems_tpu import seeds
    from libmems_tpu.anchorscore import (seed_occurrence_list,
                                         seed_occurrence_list_np,
                                         seed_occurrence_lists)
    from libmems_tpu.sequence import Genome
    from libmems_tpu.sml import SortedMerList

    rng = np.random.default_rng(11)
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    seed = seeds.get_seed(11, 0)

    # plain genome
    codes = rng.integers(0, 4, 6000).astype(np.uint8)
    g = Genome(name="a", ascii=lut[codes], codes=codes)
    sml = SortedMerList.create(g, seed)
    np.testing.assert_array_equal(seed_occurrence_list(sml),
                                  seed_occurrence_list_np(g, seed))

    # ambiguity-masked genome (N runs -> sentinel windows count 1)
    asc = lut[codes].copy()
    asc[1000:1040] = ord("N")
    asc[3000] = ord("R")
    gn = Genome(name="n", ascii=asc)
    smln = SortedMerList.create(gn, seed)
    np.testing.assert_array_equal(seed_occurrence_list(smln),
                                  seed_occurrence_list_np(gn, seed))

    # circular genome (seed_len-1 wrap)
    gc = Genome(name="c", ascii=lut[codes], codes=codes, circular=True)
    smlc = SortedMerList.create(gc, seed)
    np.testing.assert_array_equal(seed_occurrence_list(smlc),
                                  seed_occurrence_list_np(gc, seed))

    # genome whose FINAL seed window repeats an interior window: the
    # reference leaves count[Length-1] raw (smoothFrequencies never
    # overwrites it, SeedOccurrenceList.h:76-92); with bucket padding
    # the device path's special case lands on a pad position, so the
    # restore at real_len-1 is what keeps the two paths bit-equal here
    seed_len = seeds.seed_length(seed)
    codes_r = codes.copy()
    codes_r[-seed_len:] = codes_r[100:100 + seed_len]
    gr = Genome(name="r", ascii=lut[codes_r], codes=codes_r)
    smlr = SortedMerList.create(gr, seed)
    sol_dev = seed_occurrence_list(smlr)
    sol_np = seed_occurrence_list_np(gr, seed)
    np.testing.assert_array_equal(sol_dev, sol_np)
    # raw tail count is 1; the (wrong) smoothed value would average the
    # repeating final windows into something > 1
    assert sol_np[-1] == 1.0
    grc = Genome(name="rc", ascii=lut[codes_r], codes=codes_r,
                 circular=True)
    sol_c = seed_occurrence_list(SortedMerList.create(grc, seed))
    np.testing.assert_array_equal(sol_c, seed_occurrence_list_np(grc, seed))

    # dispatcher: with genomes given, small genomes take the host twin
    # and the result set matches the device-only call
    smls = [sml, smln, smlc]
    via_host = seed_occurrence_lists(smls, [g, gn, gc])
    via_dev = seed_occurrence_lists(smls)
    for a, b in zip(via_host, via_dev):
        np.testing.assert_array_equal(a, b)
