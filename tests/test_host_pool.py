"""The host worker pool (recursion.host_pool_map) gives the serial
answer: gap re-anchoring and the refinement gate's path scores."""

import numpy as np
import pytest

from libmems_tpu import recursion
from libmems_tpu import seeds as seedlib
from libmems_tpu.sequence import Genome

_LUT = np.frombuffer(b"ACGT", dtype=np.uint8)


def _pair(rng, n=24_000):
    a = rng.integers(0, 4, size=n).astype(np.uint8)
    b = a.copy()
    sub = rng.random(n) < 0.02
    b[sub] = rng.integers(0, 4, size=int(sub.sum())).astype(np.uint8)
    return [Genome(name="a", ascii=_LUT[a], codes=a),
            Genome(name="b", ascii=_LUT[b], codes=b)]


def test_host_pool_map_preserves_order(monkeypatch):
    monkeypatch.setattr(recursion, "_POOL_SIZE", 4)
    items = list(range(37))
    assert recursion.host_pool_map(lambda x: x * x, items) == \
        [x * x for x in items]


@pytest.mark.parametrize("nway", [False, True])
def test_search_gaps_batch_pooled_equals_serial(monkeypatch, nway):
    genomes = _pair(np.random.default_rng(5))
    seed = seedlib.get_seed(9, 0)
    # host-eligible gap jobs (two members, well under HOST_PAIR_CUTOFF),
    # one of them on the reverse strand of genome b
    jobs = []
    for k in range(12):
        lo = 1 + 1900 * k
        sign = -1 if k == 3 else 1
        jobs.append((np.array([lo, sign * lo]), np.array([1500, 1500]),
                     seed))
    monkeypatch.setattr(recursion, "_POOL_SIZE", 1)
    serial = recursion.search_gaps_batch(genomes, jobs, nway=nway)
    monkeypatch.setattr(recursion, "_POOL_SIZE", 4)
    monkeypatch.setattr(recursion, "_POOL_MIN_JOBS", 2)
    pooled = recursion.search_gaps_batch(genomes, jobs, nway=nway)
    assert sum(len(m) for m in serial) > 0
    assert [m.key_set() for m in pooled] == [m.key_set() for m in serial]


def test_refine_gate_pooled_equals_serial(monkeypatch):
    """refine_windows pools its path-score sweep from 32 windows on."""
    from libmems_tpu.msa import refine_windows
    rng = np.random.default_rng(8)
    chunks = []
    for _ in range(34):
        anc = rng.integers(0, 4, size=40).astype(np.uint8)
        rows = np.stack([np.where(rng.random(40) < 0.1,
                                  rng.integers(0, 4, size=40), anc)
                         for _ in range(3)]).astype(np.uint8)
        rows[rng.integers(0, 3), rng.integers(0, 40, size=3)] = 4
        chunks.append(rows)
    monkeypatch.setattr(recursion, "_POOL_SIZE", 1)
    serial = refine_windows(chunks)
    monkeypatch.setattr(recursion, "_POOL_SIZE", 4)
    pooled = refine_windows(chunks)
    assert all(np.array_equal(a, b) for a, b in zip(pooled, serial))


def test_path_scores_pooled_equal_serial(monkeypatch):
    from libmems_tpu.ops.profile import profile_path_scores_single
    rng = np.random.default_rng(9)
    wins = [rng.integers(0, 5, size=(4, 120)).astype(np.uint8)
            for _ in range(40)]
    monkeypatch.setattr(recursion, "_POOL_SIZE", 4)
    pooled = recursion.host_pool_map(profile_path_scores_single, wins)
    for w, got in zip(wins, pooled):
        np.testing.assert_array_equal(got, profile_path_scores_single(w))
