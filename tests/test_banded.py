"""Banded profile-DP parity.

The banded fast path must be INVISIBLE in results: certified windows
produce byte-identical tracebacks/scores to the full-width DP, and
windows failing the optimality certificate (large indels, heavy
repeats) silently re-run at full width.  These tests compare
align_profile_batch / profile_scores_batch against the same calls with
banding disabled.
"""

import numpy as np
import pytest


def _mutant_pair(rng, n, mutate=0.01, indel_at=None, indel_len=0):
    a = rng.integers(0, 4, n).astype(np.uint8)
    b = a.copy()
    m = rng.random(n) < mutate
    b[m] = (b[m] + rng.integers(1, 4, int(m.sum()))) % 4
    if indel_at is not None:
        ins = rng.integers(0, 4, indel_len).astype(np.uint8)
        b = np.concatenate([b[:indel_at], ins, b[indel_at:]])
    return a, b


def _no_band(monkeypatch):
    from libmems_tpu.ops import profile
    monkeypatch.setattr(profile, "BAND_MIN_N", 1 << 30)


def test_band_eligible():
    from libmems_tpu.ops.profile import BAND_K, _band_eligible, _band_wb
    pl = np.array([900, 0, 100, 500], np.int32)
    ql = np.array([905, 10, 900, 0], np.int32)
    el = _band_eligible(pl, ql, 1024, 1024)
    assert el.tolist() == [True, False, False, False]
    # tiny buckets never band
    assert not _band_eligible(pl, ql, 1024, 256).any()
    assert not _band_eligible(pl, ql, BAND_K, 1024).any()
    assert _band_wb(1024) < 1024


def test_banded_scores_match_full():
    """Certified banded forward scores are exactly the full-DP scores;
    uncertified elements fall back inside profile_scores_batch."""
    from libmems_tpu.ops.profile import (_band_eligible, _band_half,
                                         _banded_forward_scores,
                                         CKPT_ROWS, profile_forward_ckpt,
                                         rows_to_profile)
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    N = 1024
    pairs = []
    a, b = _mutant_pair(rng, 900)                      # near-diagonal
    pairs.append((a, b))
    a, b = _mutant_pair(rng, 700, indel_at=350, indel_len=300)
    pairs.append((a, b))                               # giant indel
    nbp = 4
    Mp = -(-N // CKPT_ROWS) * CKPT_ROWS
    p = np.zeros((nbp, Mp, 5), np.float32)
    q = np.zeros((nbp, N, 5), np.float32)
    p_len = np.zeros(nbp, np.int32)
    q_len = np.zeros(nbp, np.int32)
    for r, (pa, qa) in enumerate(pairs):
        p[r, :len(pa)] = rows_to_profile(pa.reshape(1, -1))
        q[r, :len(qa)] = rows_to_profile(qa.reshape(1, -1))
        p_len[r], q_len[r] = len(pa), len(qa)
    sb, cert = _banded_forward_scores(
        jnp.asarray(p), jnp.asarray(q), jnp.asarray(p_len),
        jnp.asarray(q_len), -400, -30, _band_half(N))
    sf, _, _ = profile_forward_ckpt(
        jnp.asarray(p), jnp.asarray(q), jnp.asarray(p_len),
        jnp.asarray(q_len), -400, -30, Mp)
    sb, cert, sf = map(np.asarray, (sb, cert, sf))
    assert cert[0], "near-diagonal window must certify"
    assert sb[0] == sf[0], "certified banded score must equal full"
    # the giant-indel window must NOT certify with a wrong score
    assert (not cert[1]) or sb[1] == sf[1]
    assert _band_eligible(p_len, q_len, Mp, N)[0]


def test_align_profile_batch_banded_parity(monkeypatch):
    """align_profile_batch with banding == without, byte for byte,
    across certify-and-fallback cases."""
    from libmems_tpu.ops import profile

    rng = np.random.default_rng(7)
    p_rows, q_rows = [], []
    # near-identical pair (certifies)
    a, b = _mutant_pair(rng, 950)
    p_rows.append(a.reshape(1, -1))
    q_rows.append(b.reshape(1, -1))
    # pair with a big indel (certificate fails -> full fallback)
    a, b = _mutant_pair(rng, 800, indel_at=400, indel_len=300)
    p_rows.append(a.reshape(1, -1))
    q_rows.append(b.reshape(1, -1))
    # multi-row profiles with gap columns (occupancy < 1)
    a, b = _mutant_pair(rng, 900, mutate=0.02)
    rows = np.stack([a, np.where(rng.random(900) < 0.02, 4, b)])
    c, d = _mutant_pair(rng, 905, mutate=0.02)
    p_rows.append(rows.astype(np.uint8))
    q_rows.append(c.reshape(1, -1))

    banded = profile.align_profile_batch(p_rows, q_rows, mesh=None)
    _no_band(monkeypatch)
    full = profile.align_profile_batch(p_rows, q_rows, mesh=None)
    for x, y in zip(banded, full):
        assert np.array_equal(x, y)


def test_profile_scores_batch_banded_parity(monkeypatch):
    from libmems_tpu.ops import profile

    rng = np.random.default_rng(11)
    p_rows, q_rows = [], []
    for n, ins in ((940, 0), (820, 350), (600, 0)):
        a, b = _mutant_pair(rng, n, indel_at=n // 2 if ins else None,
                            indel_len=ins)
        p_rows.append(a.reshape(1, -1))
        q_rows.append(b.reshape(1, -1))
    banded = profile.profile_scores_batch(p_rows, q_rows)
    _no_band(monkeypatch)
    full = profile.profile_scores_batch(p_rows, q_rows)
    np.testing.assert_array_equal(banded, full)


@pytest.mark.slow
def test_banded_parity_large_bucket(monkeypatch):
    """4096-column bucket (the refine-window bucket): banded traceback
    byte-equal to full on a 2.5k-col near-identical window."""
    from libmems_tpu.ops import profile

    rng = np.random.default_rng(13)
    a, b = _mutant_pair(rng, 2500)
    p_rows = [a.reshape(1, -1)]
    q_rows = [b.reshape(1, -1)]
    banded = profile.align_profile_batch(p_rows, q_rows, mesh=None)
    _no_band(monkeypatch)
    full = profile.align_profile_batch(p_rows, q_rows, mesh=None)
    assert np.array_equal(banded[0], full[0])
