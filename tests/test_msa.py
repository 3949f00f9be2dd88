"""MSA engine: profile DP, progressive alignment, refinement, scoring
(reference: MuscleInterface.cpp usage of libMUSCLE; Scoring.h)."""

import numpy as np
import pytest

from libmems_tpu.msa import align_codes, align_window_group, refine
from libmems_tpu.ops.profile import GAP_CODE, align_profile_batch
from libmems_tpu.scoring import (ascii_rows_to_codes, codes_rows_to_ascii,
                                 consensus_score, pairwise_gap_score,
                                 pairwise_match_score, sp_score)
from libmems_tpu.sequence import translate_dna
from libmems_tpu.tree import parse_newick, assign_sequence_ids


def codes(s: str) -> np.ndarray:
    return translate_dna(s)


def to_strs(rows: np.ndarray) -> list[str]:
    return ["".join("ACGT-"[c] for c in row) for row in rows]


def test_identical_sequences_align_without_gaps():
    s = codes("ACGTACGTACGTGCA")
    rows = align_codes([s, s.copy(), s.copy()])
    assert rows.shape == (3, 15)
    assert (rows != GAP_CODE).all()
    assert (rows[0] == rows[1]).all()


def test_single_insertion_recovered():
    a = codes("ACGTACGTACGT")
    b = codes("ACGTACGGTACGT")  # extra G inserted mid-sequence
    rows = align_codes([a, b])
    strs = to_strs(rows)
    assert len(strs[0]) == 13
    assert strs[0].count("-") == 1
    assert strs[1].count("-") == 0
    # ungapped content preserved
    assert strs[0].replace("-", "") == "ACGTACGTACGT"
    assert strs[1] == "ACGTACGGTACGT"


def test_deletion_recovered():
    a = codes("AAAACCCCGGGGTTTT")
    b = codes("AAAAGGGGTTTT")     # CCCC deleted
    rows = align_codes([a, b])
    strs = to_strs(rows)
    assert strs[0] == "AAAACCCCGGGGTTTT"
    assert strs[1].replace("-", "") == "AAAAGGGGTTTT"
    assert strs[1].count("-") == 4
    # gap must be contiguous (affine)
    g0 = strs[1].index("-")
    assert strs[1][g0:g0 + 4] == "----"


def test_three_way_progressive():
    a = codes("ACGTACGTACGTACGTAAAA")
    b = codes("ACGTACGTACGTACGTAAAA")
    c = codes("ACGTACGTTTACGTACGTAAAA")  # TT insertion
    rows = align_codes([a, b, c])
    strs = to_strs(rows)
    assert strs[0].replace("-", "") == "ACGTACGTACGTACGTAAAA"
    assert strs[2].replace("-", "") == "ACGTACGTTTACGTACGTAAAA"
    assert len(set(len(s) for s in strs)) == 1
    assert strs[0] == strs[1]  # identical inputs, identical rows


def test_window_group_batched_matches_single():
    a1, b1 = codes("ACGTACGTACGT"), codes("ACGTACGGTACGT")
    a2, b2 = codes("TTTTGGGGCCCC"), codes("TTTTGGCCCC")
    tree = assign_sequence_ids(parse_newick("(seq1:0.1,seq2:0.1);"))
    batch = align_window_group([[a1, b1], [a2, b2]], tree)
    solo1 = align_window_group([[a1, b1]], tree)[0]
    solo2 = align_window_group([[a2, b2]], tree)[0]
    assert (batch[0] == solo1).all()
    assert (batch[1] == solo2).all()


def test_empty_fragment_all_gaps():
    a = codes("ACGTACGT")
    b = codes("")
    rows = align_codes([a, b])
    assert rows.shape == (2, 8)
    assert (rows[1] == GAP_CODE).all()


def test_refine_never_worsens_sp():
    rng = np.random.default_rng(3)
    base = rng.integers(0, 4, size=60).astype(np.uint8)
    seqs = []
    for _ in range(4):
        s = base.copy()
        # random point mutations + a small indel
        pos = rng.integers(0, len(s), size=4)
        s[pos] = rng.integers(0, 4, size=4)
        cut = rng.integers(10, 50)
        s = np.concatenate([s[:cut], s[cut + 3:]])
        seqs.append(s)
    rows = align_codes(seqs)
    before = sp_score(codes_rows_to_ascii(rows))
    refined = refine(rows, iters=2)
    after = sp_score(codes_rows_to_ascii(refined))
    assert after >= before
    # content preserved
    for i in range(4):
        orig = "".join("ACGT"[c] for c in seqs[i])
        got = to_strs(refined)[i].replace("-", "")
        assert got == orig


# -- scoring ---------------------------------------------------------------

def arow(s: str) -> np.ndarray:
    return np.frombuffer(s.encode(), dtype=np.uint8)


def test_match_score_hoxd():
    assert pairwise_match_score(arow("A"), arow("A")) == 91
    assert pairwise_match_score(arow("A"), arow("T")) == -123
    assert pairwise_match_score(arow("AC"), arow("A-")) == 91


def test_gap_score_affine():
    # one run of 3 gap columns: open + 2*extend
    assert pairwise_gap_score(arow("AAAA"), arow("A---")) == -400 - 60
    # two separate runs
    assert pairwise_gap_score(arow("AAAAA"), arow("-AAA-")) == 2 * -400
    # both-gap columns are skipped entirely
    assert pairwise_gap_score(arow("A--A"), arow("A--A")) == 0
    # both-gap column inside a single-gap run does not split the run
    assert pairwise_gap_score(arow("AA-AA"), arow("A---A")) == -400 - 30
    # side switch opens a new gap
    assert pairwise_gap_score(arow("A-GA"), arow("AC-A")) == 2 * -400


def test_sp_score_sums_pairs():
    rows = np.stack([arow("ACGT"), arow("ACGT"), arow("AC-T")])
    expect = (pairwise_match_score(rows[0], rows[1])
              + pairwise_match_score(rows[0], rows[2])
              + pairwise_match_score(rows[1], rows[2])
              + 2 * -400)
    assert sp_score(rows) == expect


def test_consensus_score_majority():
    rows = np.stack([arow("AAAA"), arow("AAAA"), arow("CAAA")])
    total, cons = consensus_score(rows)
    assert cons.tobytes() == b"AAAA"


def test_ascii_codes_roundtrip():
    rows = np.stack([arow("AC-T"), arow("GGGG")])
    back = codes_rows_to_ascii(ascii_rows_to_codes(rows))
    assert (back == rows).all()


def test_profile_dp_sharded_matches_single_device():
    """The window-batch DP sharded over the 8-device mesh (shard_map on
    the batch axis) must be bit-identical to single-device execution
    (AlignLCBInParallel parallelism on the mesh)."""
    import jax
    import numpy as np
    from libmems_tpu.ops.profile import align_profile_batch, dp_mesh

    assert jax.device_count() >= 2
    assert dp_mesh() is not None
    rng = np.random.default_rng(31)
    p_rows, q_rows = [], []
    for _ in range(19):   # odd count: exercises batch padding
        cp = int(rng.integers(5, 120))
        cq = int(rng.integers(5, 120))
        p_rows.append(rng.integers(0, 5, size=(2, cp)).astype(np.uint8))
        q_rows.append(rng.integers(0, 5, size=(1, cq)).astype(np.uint8))
    sharded = align_profile_batch(p_rows, q_rows)          # auto mesh
    single = align_profile_batch(p_rows, q_rows, mesh=None)
    assert len(sharded) == len(single)
    for a, b in zip(sharded, single):
        assert np.array_equal(a, b)


def test_profile_path_scores_single_parity():
    """Vectorized all-rows path score must match the generic
    profile_path_score for every single-row bipartition (within fp
    reassociation tolerance, far below the refine gate's threshold)."""
    import numpy as np
    from libmems_tpu.ops.profile import (profile_path_score,
                                         profile_path_scores_single)

    rng = np.random.default_rng(5)
    for G, C in ((3, 40), (9, 300), (5, 1)):
        rows = rng.integers(0, 5, (G, C)).astype(np.uint8)
        # inject multi-column gap RUNS (extend accounting + run merging
        # across dropped columns), including an all-gap column
        for r in range(G):
            for _ in range(3):
                a = int(rng.integers(0, C))
                k = int(rng.integers(1, min(8, C - a) + 1))
                rows[r, a:a + k] = 4
        if C >= 2:
            rows[:, C // 2] = 4       # whole column all-gap
        vec = profile_path_scores_single(rows)
        for g in range(G):
            mask = np.zeros(G, bool)
            mask[g] = True
            ref = profile_path_score(rows[mask], rows[~mask])
            assert abs(vec[g] - ref) <= 1e-6 * max(abs(ref), 1.0), \
                (G, C, g, vec[g], ref)
