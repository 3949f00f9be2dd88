"""MUM discovery parity: device pipeline vs loop-faithful reference oracle.

Covers MemHash default semantics (unique multi-MUMs) and
PairwiseMatchFinder semantics on synthetic genomes with point mutations,
reverse-complemented segments, rearrangements, and repeats.
"""

import numpy as np
import pytest

from libmems_tpu import seeds as seedlib
from libmems_tpu.match import MatchArray
from libmems_tpu.matchfind import find_mums, find_pairwise_mums
from tests.oracle.refimpl import (find_mums_oracle, find_pairwise_oracle,
                                  match_set)

ALPHA = np.array(list("ACGT"))


def rc(s: str) -> str:
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    return "".join(comp[c] for c in reversed(s))


def random_seq(rng, n):
    return "".join(rng.choice(ALPHA, size=n))


def mutate(rng, s, rate):
    chars = np.array(list(s))
    idx = rng.random(len(chars)) < rate
    chars[idx] = rng.choice(ALPHA, size=idx.sum())
    return "".join(chars)


def _check_mums(seqs, seed, **kw):
    got = find_mums(seqs, seed, **kw)
    want = match_set(find_mums_oracle(seqs, seed, **{
        k: v for k, v in kw.items() if k in ("repeat_tolerance",)}))
    assert got.key_set() == want


def _check_pairwise(seqs, seed):
    got = find_pairwise_mums(seqs, seed)
    want = match_set(find_pairwise_oracle(seqs, seed))
    assert got.key_set() == want


@pytest.mark.parametrize("seedspec", [(5, 0), (7, 0), (9, 0)])
def test_pairwise_mutated(seedspec):
    seed = seedlib.get_seed(*seedspec)
    rng = np.random.default_rng(1)
    a = random_seq(rng, 500)
    b = mutate(rng, a, 0.03)
    _check_mums([a, b], seed)
    _check_pairwise([a, b], seed)


def test_reverse_complement_segment():
    seed = seedlib.get_seed(7, 0)
    rng = np.random.default_rng(2)
    a = random_seq(rng, 600)
    b = a[:200] + rc(a[200:400]) + a[400:]
    _check_mums([a, b], seed)
    _check_pairwise([a, b], seed)


def test_rearrangement():
    seed = seedlib.get_seed(7, 0)
    rng = np.random.default_rng(3)
    blocks = [random_seq(rng, 150) for _ in range(4)]
    a = "".join(blocks)
    b = blocks[2] + blocks[0] + rc(blocks[3]) + blocks[1]
    _check_mums([a, b], seed)


def test_three_genomes():
    seed = seedlib.get_seed(7, 0)
    rng = np.random.default_rng(4)
    a = random_seq(rng, 400)
    b = mutate(rng, a, 0.02)
    c = mutate(rng, a, 0.05)
    _check_mums([a, b, c], seed)
    _check_pairwise([a, b, c], seed)


def test_repeats_are_dropped():
    """A segment duplicated within one genome kills its seeds in default
    unique-MUM mode (repeat_tolerance=0)."""
    seed = seedlib.get_seed(5, 0)
    rng = np.random.default_rng(5)
    core = random_seq(rng, 120)
    a = core + random_seq(rng, 80) + core  # internal repeat
    b = core + random_seq(rng, 60)
    _check_mums([a, b], seed)
    _check_pairwise([a, b], seed)


def test_identical_genomes():
    seed = seedlib.get_seed(7, 0)
    rng = np.random.default_rng(6)
    a = random_seq(rng, 300)
    _check_mums([a, a], seed)


def test_short_and_empty_overlap():
    seed = seedlib.get_seed(5, 0)
    rng = np.random.default_rng(7)
    a = random_seq(rng, 60)
    b = random_seq(rng, 60)  # likely no shared seeds
    got = find_mums([a, b], seed)
    want = match_set(find_mums_oracle([a, b], seed))
    assert got.key_set() == want


def test_four_genome_multiplicity():
    seed = seedlib.get_seed(7, 0)
    rng = np.random.default_rng(8)
    a = random_seq(rng, 350)
    seqs = [a] + [mutate(rng, a, r) for r in (0.01, 0.04, 0.08)]
    _check_mums(seqs, seed)
    got3 = find_mums(seqs, seed, min_multiplicity=4)
    assert (got3.multiplicity() >= 4).all()
    full = find_mums(seqs, seed)
    want = {k for k in full.key_set()
            if sum(1 for s in k[0] if s != 0) >= 4}
    assert got3.key_set() == want


def test_multiplicity_and_length_filters():
    seed = seedlib.get_seed(5, 0)
    rng = np.random.default_rng(9)
    a = random_seq(rng, 200)
    b = mutate(rng, a, 0.05)
    m = find_mums([a, b], seed)
    lf = m.length_filter(20)
    assert (lf.lengths >= 20).all()
    mf = m.multiplicity_filter(2)
    assert len(mf) == len(m)


@pytest.mark.parametrize("rt,et", [(1, 2), (2, 2), (2, 3)])
def test_enumeration_tolerance_expansion(rt, et):
    """enumeration_tolerance>1: odometer expansion over each surviving
    seed's first `et` occurrences per genome (MemHash.cpp:139-162,
    MatchFinder.cpp:342-393), oracle parity on repeat-rich input."""
    seed = seedlib.get_seed(5, 0)
    rng = np.random.default_rng(7)
    core = random_seq(rng, 80)
    # repeats within each genome so runs have multiple per-genome hits
    a = core + random_seq(rng, 60) + core + random_seq(rng, 50)
    b = mutate(rng, core, 0.02) + random_seq(rng, 40) \
        + mutate(rng, core, 0.02)
    got = find_mums([a, b], seed, repeat_tolerance=rt,
                    enumeration_tolerance=et)
    want = match_set(find_mums_oracle([a, b], seed, repeat_tolerance=rt,
                                      enumeration_tolerance=et))
    assert got.key_set() == want


def test_enumeration_tolerance_three_genomes():
    seed = seedlib.get_seed(5, 0)
    rng = np.random.default_rng(11)
    core = random_seq(rng, 70)
    seqs = [core + random_seq(rng, 30) + core,
            mutate(rng, core, 0.02) + random_seq(rng, 25),
            random_seq(rng, 20) + mutate(rng, core, 0.02)]
    got = find_mums(seqs, seed, repeat_tolerance=2,
                    enumeration_tolerance=2)
    want = match_set(find_mums_oracle(seqs, seed, repeat_tolerance=2,
                                      enumeration_tolerance=2))
    assert got.key_set() == want


# ----------------------------------------------------------------------
# seq_mask (MaskedMemHash::HashMatch, libMems/MaskedMemHash.cpp:38-63)
# ----------------------------------------------------------------------

def test_seq_mask_full_nway_equals_multiplicity_filter():
    rng = np.random.default_rng(11)
    base = random_seq(rng, 1500)
    seqs = [base, mutate(rng, base, 0.02), mutate(rng, base, 0.02)]
    seed = seedlib.get_seed(7, 0)
    full = find_mums(seqs, seed)
    masked = find_mums(seqs, seed, seq_mask=0b111)
    assert masked.key_set() == full.multiplicity_filter(3).key_set()
    assert (masked.multiplicity() == 3).all()


def test_seq_mask_partial_pattern():
    rng = np.random.default_rng(12)
    base = random_seq(rng, 1200)
    # genome 1 diverges hard so some seeds live only in genomes {0, 2}
    seqs = [base, mutate(rng, base, 0.30), mutate(rng, base, 0.02)]
    seed = seedlib.get_seed(7, 0)
    full = find_mums(seqs, seed)
    # mask bit (G-1-seqI) <-> genome seqI: genomes {0,2} = 0b101
    masked = find_mums(seqs, seed, seq_mask=0b101)
    pattern = ((full.starts != 0) == np.array([True, False, True])).all(axis=1)
    want = {(tuple(int(x) for x in row), int(l))
            for row, l, ok in zip(full.starts, full.lengths, pattern) if ok}
    assert masked.key_set() == want
    if len(masked):
        assert (masked.starts[:, 1] == 0).all()


def test_seq_mask_unsatisfiable_is_empty():
    rng = np.random.default_rng(13)
    base = random_seq(rng, 600)
    seqs = [base, mutate(rng, base, 0.02)]
    seed = seedlib.get_seed(7, 0)
    assert len(find_mums(seqs, seed, seq_mask=0b10)) == 0


# ----------------------------------------------------------------------
# host (numpy) pair path parity
# ----------------------------------------------------------------------

def test_find_pair_mums_np_matches_device():
    from libmems_tpu.matchfind import find_pair_mums_np
    from libmems_tpu.sequence import translate_dna
    rng = np.random.default_rng(21)
    for trial in range(4):
        base = random_seq(rng, 3000)
        other = mutate(rng, base, 0.02)
        if trial % 2:
            other = other[:1200] + rc(other[1200:2200]) + other[2200:]
        seed = seedlib.get_seed(9, 0)
        dev = find_mums([base, other], seed)
        host = find_pair_mums_np(translate_dna(base),
                                 translate_dna(other), seed)
        assert host.key_set() == dev.key_set(), trial


@pytest.mark.slow
def test_fused_pairwise_matches_host_orchestration():
    """The fused device PairwiseMatchFinder pipeline must be row-identical
    to the host-orchestrated twin (which fetches the whole seed table)."""
    from libmems_tpu.matchfind import _find_pairwise_mums_host, _as_smls
    rng = np.random.default_rng(31)
    base = random_seq(rng, 1500)
    for trial in range(3):
        seqs = [base, mutate(rng, base, 0.02), mutate(rng, base, 0.05)]
        if trial == 1:
            seqs.append(base[:700] + rc(base[700:1100]) + base[1100:])
        if trial == 2:
            # in-genome repeat: those seeds drop out of that genome only
            seqs[1] = seqs[1][:300] + seqs[1][300:600] + seqs[1][300:]
        smls, seed = _as_smls(seqs, seedlib.get_seed(9, 0))
        dev = find_pairwise_mums(smls)
        host = _find_pairwise_mums_host(smls)
        assert dev.key_set() == host.key_set(), trial
