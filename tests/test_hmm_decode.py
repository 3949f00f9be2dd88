"""Viterbi + Baum-Welch for the homology HMM, checked against brute
force (all 2^T state paths) on short sequences."""

import itertools

import numpy as np
import pytest

from libmems_tpu.ops import hmm


def _brute_best_path(obs, p):
    ls, lt, lstop, le = hmm._log_matrices(p)
    best, best_path = -np.inf, None
    T = len(obs)
    for path in itertools.product((0, 1), repeat=T):
        lp = ls[path[0]] + le[path[0], obs[0]]
        for t in range(1, T):
            lp += lt[path[t - 1], path[t]] + le[path[t], obs[t]]
        lp += lstop[path[-1]]
        if lp > best:
            best, best_path = lp, path
    return np.array(best_path) == 0


def _brute_loglik(obs, p):
    ls, lt, lstop, le = hmm._log_matrices(p)
    T = len(obs)
    total = -np.inf
    for path in itertools.product((0, 1), repeat=T):
        lp = ls[path[0]] + le[path[0], obs[0]]
        for t in range(1, T):
            lp += lt[path[t - 1], path[t]] + le[path[t], obs[t]]
        lp += lstop[path[-1]]
        total = np.logaddexp(total, lp)
    return total


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_viterbi_matches_bruteforce(seed):
    rng = np.random.default_rng(seed)
    p = hmm.hoxd_params()
    seqs = [rng.integers(0, 8, size=n).astype(np.uint8)
            for n in (1, 3, 7, 11)]
    got = hmm.viterbi_homologous(seqs, p)
    for s, g in zip(seqs, got):
        want = _brute_best_path(s, p)
        assert np.array_equal(g, want), (s, g, want)


def test_viterbi_identity_run_is_homologous():
    # long identity run (symbols 0/1) should decode homologous; a long
    # gap-extend run (symbol 7) should decode unrelated
    p = hmm.hoxd_params()
    ident = np.zeros(200, np.uint8)
    gaps = np.full(200, 7, np.uint8)
    vi, vg = hmm.viterbi_homologous([ident, gaps], p)
    assert vi.all()
    assert not vg[50:].any()


def test_baum_welch_loglik_monotone_and_improves():
    rng = np.random.default_rng(3)
    # corpus drawn mostly from the homologous emission distribution
    p0 = hmm.hoxd_params()
    seqs = [rng.choice(8, size=120, p=p0.emit_homologous)
            .astype(np.uint8) for _ in range(5)]
    seqs += [rng.choice(8, size=37, p=p0.emit_unrelated)
             .astype(np.uint8) for _ in range(3)]
    fitted, lls = hmm.baum_welch(seqs, p0, iterations=6)
    assert len(lls) == 6
    # EM log-likelihood is non-decreasing (small slack for pseudocounts)
    assert all(b >= a - 1e-3 for a, b in zip(lls, lls[1:])), lls
    assert lls[-1] > lls[0]
    # fitted params remain valid distributions
    assert np.isclose(fitted.emit_homologous.sum(), 1.0, atol=1e-6)
    assert np.isclose(fitted.emit_unrelated.sum(), 1.0, atol=1e-6)
    assert 0 < fitted.go_homologous < 1
    assert 0 < fitted.go_unrelated < 1


def test_baum_welch_loglik_matches_bruteforce_first_iter():
    rng = np.random.default_rng(4)
    p = hmm.hoxd_params()
    seqs = [rng.integers(0, 8, size=n).astype(np.uint8) for n in (2, 5, 9)]
    _, lls = hmm.baum_welch(seqs, p, iterations=1)
    want = sum(_brute_loglik(s, p) for s in seqs)
    assert np.isclose(lls[0], want, rtol=1e-5), (lls[0], want)


def test_checkpointed_fb_matches_unblocked():
    """The memory-bounded blocked F/B must match the un-blocked scan on
    ragged batches (checkpoint recompute correctness)."""
    import jax.numpy as jnp
    import numpy as np
    from libmems_tpu.ops import hmm

    rng = np.random.default_rng(13)
    params = hmm.hoxd_params()
    ls, lt, lstop, le = (jnp.asarray(x)
                         for x in hmm._log_matrices(params))
    B, T, K = 8, 2048, 128
    obs = rng.integers(0, 8, size=(B, T)).astype(np.int32)
    lens = np.array([T, 1, 2, K, K + 1, 777, T - 1, 1500],
                    dtype=np.int32)
    p1 = np.asarray(hmm._fb_posterior(
        jnp.asarray(obs), jnp.asarray(lens), ls, lt, lstop, le))
    p2 = np.asarray(hmm._fb_posterior_ckpt(
        jnp.asarray(obs), jnp.asarray(lens), ls, lt, lstop, le, K))
    for b in range(B):
        np.testing.assert_allclose(p1[b, :lens[b]], p2[b, :lens[b]],
                                   atol=1e-5)


def test_fb_assoc_matches_sequential_calls():
    """The associative-scan F/B (log-depth prefix products of 2x2
    transfer planes — the long-alignment path of predict_homologous)
    must reproduce the sequential scan's posterior calls; columns whose
    posterior sits within 1e-3 of the 0.9 threshold are excluded (f32
    reassociation moves them either way)."""
    import jax.numpy as jnp
    import numpy as np
    from libmems_tpu.ops import hmm

    rng = np.random.default_rng(29)
    params = hmm.adapted_hoxd_params(0.5)
    ls, lt, lstop, le = (jnp.asarray(x)
                         for x in hmm._log_matrices(params))
    B, T = 4, 4096
    obs = rng.integers(0, 8, size=(B, T)).astype(np.int32)
    lens = np.array([T, T - 5, T // 2, 64], dtype=np.int32)
    post = np.asarray(hmm._fb_posterior(
        jnp.asarray(obs), jnp.asarray(lens), ls, lt, lstop, le))
    packed = np.asarray(hmm._fb_calls_assoc(
        jnp.asarray(obs), jnp.asarray(lens), ls, lt, lstop, le, 0.9))
    calls_a = np.unpackbits(packed, axis=1,
                            bitorder="little").astype(bool)[:, :T]
    calls_s = post >= 0.9
    valid = np.arange(T)[None, :] < lens[:, None]
    sure = np.abs(post - 0.9) > 1e-3
    assert not ((calls_a != calls_s) & valid & sure).any()
    # padding columns never call homologous
    assert not (calls_a & ~valid).any()


@pytest.mark.parametrize("n_blocks", [4, 64])
def test_fb_assoc_multi_block_matches_sequential_calls(n_blocks):
    """Several FB_ASSOC_BLOCK blocks per row: the block-total carries of
    the forward and (reverse-order) backward products must reproduce
    the sequential scan's calls in every block, not only the first, and
    at 2^18 columns float32 must still resolve the posteriors (the
    log-likelihood there is ~1e5 in magnitude)."""
    import jax.numpy as jnp
    import numpy as np
    from libmems_tpu.ops import hmm

    rng = np.random.default_rng(31)
    params = hmm.hoxd_params()
    ls, lt, lstop, le = (jnp.asarray(x)
                         for x in hmm._log_matrices(params))
    B, T = 2, n_blocks * hmm.FB_ASSOC_BLOCK
    # homologous-looking columns with an unrelated stretch in block 2
    obs = rng.choice(8, size=(B, T), p=[.6, .3, .02, .02, .02, .02, .01,
                                         .01]).astype(np.int32)
    obs[:, 9000:10500] = rng.integers(0, 8, size=(B, 1500))
    lens = np.array([T, T - 3000], dtype=np.int32)
    post = np.asarray(hmm._fb_posterior_ckpt(
        jnp.asarray(obs), jnp.asarray(lens), ls, lt, lstop, le,
        hmm.FB_CKPT_COLS))
    packed = np.asarray(hmm._fb_calls_assoc(
        jnp.asarray(obs), jnp.asarray(lens), ls, lt, lstop, le, 0.9))
    calls_a = np.unpackbits(packed, axis=1,
                            bitorder="little").astype(bool)[:, :T]
    valid = np.arange(T)[None, :] < lens[:, None]
    sure = np.abs(post - 0.9) > 1e-3
    assert ((post >= 0.9) & valid).any() and ((post < 0.9) & valid).any()
    assert not ((calls_a != (post >= 0.9)) & valid & sure).any()
