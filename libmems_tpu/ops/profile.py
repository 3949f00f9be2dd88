"""Batched profile-profile global alignment with affine gaps.

The compute core of the batched MSA engine (libmems_tpu.msa) that
replaces the reference's in-process libMUSCLE profile alignment
(MuscleInterface::ProfileAlignFast, libMems/MuscleInterface.cpp:1053;
CallMuscleFast :727-769).  A profile is a column distribution over the
5-letter alphabet (A,C,G,T,gap); the substitution score between profile
columns is the expected HOXD70 pair score

    S(i, j) = p_i^T · W · q_j

computed as one small matmul per DP row, with gap-open/extend costs
scaled by the partner column's non-gap occupancy (a standard profile-SP
approximation of MUSCLE's scoring; alignment *content* parity with
MUSCLE is not a goal — anchor-framework parity is, SURVEY.md M4).

The DP is the same max-plus-prefix Gotoh recurrence as
libmems_tpu.ops.gapped: one `lax.scan` over rows, the within-row E
dependency resolved with a cummax, packed pointer bytes for a host
traceback.  All pairs in a batch run in lockstep over padded shapes.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from libmems_tpu import _jaxconfig  # noqa: F401
from libmems_tpu.ops.gapped import (E_EXT_BIT, F_EXT_BIT, GAP_EXTEND,
                                    GAP_OPEN, H_DIAG, H_E, H_F, HOXD70)

GAP_CODE = 4

# 5x5 expected-score matrix: HOXD70 over ACGT; a gap in an input profile
# column contributes 0 to the cross term (gap-vs-gap and gap-vs-base cost
# is carried by the affine gap machinery, not the substitution score).
W5 = np.zeros((5, 5), dtype=np.float32)
W5[:4, :4] = HOXD70.astype(np.float32)

NEG_BIG = np.float32(-1e30)


CKPT_ROWS = 128   # forward-carry checkpoint spacing (traceback block)


def _profile_row_fn(qw, ext_q, ext_cum, q_len, gap_open, emit_ptr: bool):
    """Per-row scan body shared by the checkpointed forward pass and the
    per-block pointer re-derivation (see ops.gapped for the scheme)."""
    B, N = ext_q.shape

    def row(carry, xs):
        h_prev, f_prev = carry                       # [B, N+1]
        p_i, ext_pi = xs                             # [B, 5], [B]
        # vertical gap (gap in q, consume p row i); occupancy scales the
        # extend cost (profile-SP standard), the open cost is unscaled
        f_open = h_prev + gap_open + ext_pi[:, None]
        f_ext = f_prev + ext_pi[:, None]
        f_row = jnp.maximum(f_open, f_ext)

        # HIGHEST: a float32 product must not drop to TF32 on the GPU,
        # or scores and traceback tie-breaks change
        s = jnp.einsum("bx,bnx->bn", p_i, qw,
                       precision=jax.lax.Precision.HIGHEST)   # [B, N]
        diag = h_prev[:, :-1] + s

        g = jnp.maximum(diag, f_row[:, 1:])
        g0 = f_row[:, :1]
        gp = jnp.concatenate([g0, g[:, :-1]], axis=1)  # k = 0..N-1
        # E[j] = ext_cum[j] + max_{k<j}(G'[k] + open - ext_cum[k])
        wk = gp + gap_open - ext_cum[:, :-1]
        e_row = ext_cum[:, 1:] + jax.lax.cummax(wk, axis=1)

        h_row_1 = jnp.maximum(g, e_row)
        h_row = jnp.concatenate([g0, h_row_1], axis=1)

        if not emit_ptr:
            h_at = jnp.take_along_axis(h_row, q_len[:, None], axis=1)[:, 0]
            return (h_row, f_row), h_at

        f_ext_bit = (f_row == f_ext) & (f_prev > NEG_BIG / 2)
        e_ext_bit = jnp.concatenate([
            jnp.zeros((B, 1), bool),
            e_row[:, 1:] == e_row[:, :-1] + ext_q[:, 1:]], axis=1)
        h_src = jnp.where(h_row_1 == diag, H_DIAG,
                          jnp.where(h_row_1 == e_row, H_E, H_F)
                          ).astype(jnp.uint8)
        ptr_j0 = jnp.full((B, 1), H_F, jnp.uint8) \
            | jnp.where(f_ext_bit[:, :1], F_EXT_BIT, 0).astype(jnp.uint8)
        ptr = (h_src
               | jnp.where(e_ext_bit, E_EXT_BIT, 0).astype(jnp.uint8)
               | jnp.where(f_ext_bit[:, 1:], F_EXT_BIT, 0).astype(jnp.uint8))
        ptr_row = jnp.concatenate([ptr_j0, ptr], axis=1)
        return (h_row, f_row), ptr_row

    return row


def _profile_q_setup(q, gap_open, gap_extend):
    B = q.shape[0]
    w = jnp.asarray(W5)
    q_occ = 1.0 - q[:, :, GAP_CODE]                 # [B, N]
    ext_q = gap_extend * q_occ                      # gap in p consumes q col
    qw = jnp.einsum("bnx,yx->bny", q, w,
                    precision=jax.lax.Precision.HIGHEST)   # [B, N, 5]
    j_idx = jnp.arange(q.shape[1] + 1, dtype=jnp.int32)
    ext_cum = jnp.concatenate(
        [jnp.zeros((B, 1), jnp.float32), jnp.cumsum(ext_q, axis=1)], axis=1)
    h0 = jnp.where(j_idx[None, :] == 0, 0.0, gap_open + ext_cum)
    # derive f0 from h0 so it inherits h0's varying manual axes under
    # shard_map (a bare jnp.full constant would break the scan-carry
    # type match when the batch axis is device-sharded)
    f0 = (h0 - h0) + NEG_BIG
    return qw, ext_q, ext_cum, h0, f0


@functools.partial(jax.jit, static_argnums=(4, 5, 6))
def profile_forward_ckpt(p, q, p_len, q_len, gap_open: int,
                         gap_extend: int, K: int):
    """Checkpointed forward profile DP (M a multiple of K).  Returns
    (score float32[B], ck_h, ck_f float32[nb, B, N+1])."""
    B, M, _ = p.shape
    nb = M // K
    qw, ext_q, ext_cum, h0, f0 = _profile_q_setup(q, gap_open, gap_extend)
    ext_p = gap_extend * (1.0 - p[:, :, GAP_CODE])  # gap in q consumes p
    row = _profile_row_fn(qw, ext_q, ext_cum, q_len, gap_open, False)

    def block(carry, xs):
        ck = carry
        carry2, h_ats = jax.lax.scan(row, carry, xs)
        return carry2, (ck[0], ck[1], h_ats)

    xs = (jnp.transpose(p, (1, 0, 2)).reshape(nb, K, B, 5),
          ext_p.T.reshape(nb, K, B))
    _, (ck_h, ck_f, h_at) = jax.lax.scan(block, (h0, f0), xs)
    h_at = h_at.reshape(M, B)
    h0_at = jnp.take_along_axis(h0, q_len[:, None], axis=1)[:, 0]
    h_at = jnp.concatenate([h0_at[None], h_at], axis=0)
    score = jnp.take_along_axis(h_at, p_len[None, :], axis=0)[0]
    return score, ck_h, ck_f


@functools.partial(jax.jit, static_argnums=(6, 7))
def profile_block_ptrs(ck_h, ck_f, p_blk, ext_p_blk, q, q_len,
                       gap_open: int, gap_extend: int):
    """Re-derive one block's pointer rows.  p_blk: float32[B, K, 5],
    ext_p_blk: float32[B, K].  Returns uint8[B, K, N+1]."""
    qw, ext_q, ext_cum, _, _ = _profile_q_setup(q, gap_open, gap_extend)
    row = _profile_row_fn(qw, ext_q, ext_cum, q_len, gap_open, True)
    xs = (jnp.transpose(p_blk, (1, 0, 2)), ext_p_blk.T)
    _, ptrs = jax.lax.scan(row, (ck_h, ck_f), xs)
    return jnp.transpose(ptrs, (1, 0, 2))


def rows_to_profile(rows: np.ndarray) -> np.ndarray:
    """Alignment rows (uint8 codes, GAP_CODE=4) -> column distribution
    float32[C, 5]."""
    n_rows, C = rows.shape
    prof = np.zeros((C, 5), dtype=np.float32)
    for a in range(5):
        prof[:, a] = (rows == a).sum(axis=0)
    return prof / max(n_rows, 1)


_DP_AXIS = "dp"
_dp_mesh_cache: list = [None]


def dp_mesh():
    """1-D mesh over this process's LOCAL devices for batch-sharding the
    window DP (the gapped-DP batch is embarrassingly
    parallel — on a multi-chip mesh every device aligns its slice of the
    window batch; one chip behaves exactly as before).  None on
    single-device backends.

    Local, not global, devices: under multi-host execution the DP is a
    redundant-deterministic per-process stage (the multihost e2e
    contract — only seeding spans the global mesh); a process-spanning
    DP mesh would also require cross-process enqueue-order coordination
    for every bucket."""
    if _dp_mesh_cache[0] is None:
        import jax as _jax
        devs = _jax.local_devices()
        if len(devs) < 2:
            _dp_mesh_cache[0] = False
        else:
            from jax.sharding import Mesh
            _dp_mesh_cache[0] = Mesh(np.array(devs), (_DP_AXIS,))
    return _dp_mesh_cache[0] or None


def _shard_forward(mesh, gap_open, gap_extend, K):
    from jax.sharding import PartitionSpec as P

    def fwd(p, q, p_len, q_len):
        return profile_forward_ckpt(p, q, p_len, q_len,
                                    gap_open, gap_extend, K)

    return jax.shard_map(
        fwd, mesh=mesh,
        in_specs=(P(_DP_AXIS), P(_DP_AXIS), P(_DP_AXIS), P(_DP_AXIS)),
        out_specs=(P(_DP_AXIS), P(None, _DP_AXIS), P(None, _DP_AXIS)))


def _shard_ptrs(mesh, gap_open, gap_extend):
    from jax.sharding import PartitionSpec as P

    def ptrs(ck_h, ck_f, p_blk, ext_p_blk, q, q_len):
        return profile_block_ptrs(ck_h, ck_f, p_blk, ext_p_blk, q,
                                  q_len, gap_open, gap_extend)

    return jax.shard_map(
        ptrs, mesh=mesh,
        in_specs=(P(_DP_AXIS),) * 6, out_specs=P(_DP_AXIS))


def _full_ptr_tb(p, ext_p, q, q_len, p_len, gap_open: int,
                 gap_extend: int, T: int):
    """Derive the FULL pointer tensor in one forward scan and walk the
    traceback on device (ops.gapped._device_tb_scan): the fetch is
    T/8 x B bit rows instead of DP-cells/2 pointer bytes (PERF rule
    20's transfer wall, applied to the profile DP)."""
    from libmems_tpu.ops.gapped import _device_tb_scan
    qw, ext_q, ext_cum, h0, f0 = _profile_q_setup(q, gap_open,
                                                  gap_extend)
    row = _profile_row_fn(qw, ext_q, ext_cum, q_len, gap_open, True)
    xs = (jnp.transpose(p, (1, 0, 2)), ext_p.T)
    _, ptrs = jax.lax.scan(row, (h0, f0), xs)
    ptrs = jnp.transpose(ptrs, (1, 0, 2))
    return _device_tb_scan(ptrs, p_len, q_len, T)


_full_ptr_tb_jit = jax.jit(_full_ptr_tb, static_argnums=(5, 6, 7))


def _shard_full_tb(mesh, gap_open, gap_extend, T):
    from jax.sharding import PartitionSpec as P

    def f(p, ext_p, q, q_len, p_len):
        return _full_ptr_tb(p, ext_p, q, q_len, p_len,
                            gap_open, gap_extend, T)

    return jax.shard_map(
        f, mesh=mesh, in_specs=(P(_DP_AXIS),) * 5,
        out_specs=(P(None, _DP_AXIS),) * 3)


# --------------------------------------------------------------------------
# banded DP (the inter-anchor windows sit between
# chained anchors, so their optimal paths hug the corner-to-corner
# diagonal; a block-banded scan cuts DP cells ~4-7x at the big column
# buckets).  EXACTNESS IS PRESERVED by a per-window certificate:
#
#   any alignment path through a cell more than H_W diagonals off the
#   straight (0,0)->(p_len,q_len) line contains at least
#   2*H_W - 3*|q_len-p_len| gap moves (triangle inequality on
#   insertions/deletions), each costing at least gap_extend*occ_min,
#   plus one gap_open; its score is therefore bounded by
#     SumCap + gap_open + gap_extend*occ_min*(2*H_W - 3*|dlen|)
#   where SumCap = sum over q columns of the best possible column score
#   (max over letters of W5 @ q_j, floored at 0 — a gap row scores 0).
#
# If the banded optimum strictly beats that bound, every optimal path
# stays strictly inside the band, all DP values on any optimal
# traceback are bit-equal to the full-width DP (same ops on the same
# floats), and the banded traceback is byte-identical to the full one.
# Windows that fail the certificate re-run at full width — no
# approximation anywhere, just a fast path that usually certifies.
#
# Reference frame being matched: GappedAligner.h:25 window cap and
# ProgressiveAligner.cpp:57-60 refine windows — near-diagonal by
# construction.
# --------------------------------------------------------------------------

BAND_K = CKPT_ROWS      # rows per band block
BAND_SMAX = 2           # max q_len/p_len slope eligible for banding
BAND_MIN_N = 1024       # smallest padded column bucket worth banding
BAND_MARGIN = 64.0      # certificate strictness slack (f32 safety)

# observability: cumulative banding outcomes (windows counted once per
# banded attempt; "fallback" = eligible but uncertified -> full rerun)
BAND_STATS = {"eligible": 0, "certified": 0, "fallback": 0,
              "ineligible": 0}


def _band_note(elig: np.ndarray, okm: np.ndarray, n: int) -> None:
    BAND_STATS["eligible"] += int(elig[:n].sum())
    BAND_STATS["certified"] += int(okm[:n].sum())
    BAND_STATS["fallback"] += int((elig[:n] & ~okm[:n]).sum())
    BAND_STATS["ineligible"] += int(n - elig[:n].sum())


def _band_half(N: int) -> int:
    """Nominal half band width for an N-column bucket: wide enough that
    ~2%-divergent windows certify (slack ~= divergence * N * 210 must be
    under |gap_extend| * 2*H_W)."""
    return max(127, N // 16 - 1)


def _band_wb(N: int) -> int:
    """Local band storage width: per 128-row block the band must cover
    K*slope columns of diagonal drift plus the nominal band on both
    sides plus one guard column below (kept at -inf so certified
    tracebacks never read a degenerate boundary pointer)."""
    return BAND_K * BAND_SMAX + 2 * _band_half(N) + 2


def _banded_block_scan(p, q, p_len, q_len, gap_open: int,
                       gap_extend: int, H_W: int, emit_ptr: bool):
    """Shared banded forward machinery.  Local column w of a block
    starting at row r0 maps to global column j = lo + w where
    lo = clip((r0*q_len)//p_len - H_W - 1, 0, N - WB): identical
    arithmetic in the traceback walk keeps addressing consistent.
    Returns (score, outs, certificate) where outs is the per-row scan
    emission ([nb, K, B] h_at rows, or ([nb,K,B,WB+1] ptrs, h_at))."""
    B, Mp, _ = p.shape
    N = q.shape[1]
    WB = BAND_K * BAND_SMAX + 2 * H_W + 2
    nb = Mp // BAND_K
    qw, ext_q, ext_cum, h0, f0 = _profile_q_setup(q, gap_open, gap_extend)
    ext_p = gap_extend * (1.0 - p[:, :, GAP_CODE])
    lo_cap = max(N - WB, 0)
    pl = jnp.maximum(p_len, 1).astype(jnp.int32)
    ql = q_len.astype(jnp.int32)

    def lo_of(bi):
        return jnp.clip((bi * BAND_K * ql) // pl - (H_W + 1), 0, lo_cap)

    w_idx = jnp.arange(WB + 1, dtype=jnp.int32)
    h0_loc = h0[:, :WB + 1]            # block 0: lo == 0 always
    f0_loc = (h0_loc - h0_loc) + NEG_BIG

    def block(carry, xs):
        h_prev, f_prev, lo_prev = carry
        p_blk, extp_blk, bi = xs       # [K,B,5], [K,B], scalar
        lo = lo_of(bi)
        src = w_idx[None, :] + (lo - lo_prev)[:, None]
        ok = src <= WB
        srcc = jnp.minimum(src, WB)
        h_sh = jnp.where(ok, jnp.take_along_axis(h_prev, srcc, axis=1),
                         NEG_BIG)
        f_sh = jnp.where(ok, jnp.take_along_axis(f_prev, srcc, axis=1),
                         NEG_BIG)
        # q-side slices of this block's band (s[w] consumes q column
        # j-1 = lo+w-1 for w=1..WB -> columns lo..lo+WB-1)
        cols = lo[:, None] + w_idx[None, :WB]
        colc = jnp.minimum(cols, N - 1)
        qw_loc = jnp.take_along_axis(qw, colc[:, :, None], axis=1)
        extq_loc = jnp.take_along_axis(ext_q, colc, axis=1)
        cum_loc = jnp.take_along_axis(
            ext_cum, jnp.minimum(lo[:, None] + w_idx[None, :], N), axis=1)
        qlen_loc = jnp.clip(ql - lo, 0, WB)
        row = _profile_row_fn(qw_loc, extq_loc, cum_loc, qlen_loc,
                              gap_open, emit_ptr)
        if emit_ptr:
            def row2(c, x):
                c2, ptr = row(c, x)
                h_at = jnp.take_along_axis(
                    c2[0], qlen_loc[:, None], axis=1)[:, 0]
                return c2, (ptr, h_at)
            (h2, f2), out = jax.lax.scan(row2, (h_sh, f_sh),
                                         (p_blk, extp_blk))
        else:
            (h2, f2), out = jax.lax.scan(row, (h_sh, f_sh),
                                         (p_blk, extp_blk))
        return (h2, f2, lo), out

    xs = (jnp.transpose(p, (1, 0, 2)).reshape(nb, BAND_K, B, 5),
          ext_p.T.reshape(nb, BAND_K, B),
          jnp.arange(nb, dtype=jnp.int32))
    # derive the initial lo from the (batch-varying) lengths so the
    # scan carry keeps its varying manual axes under shard_map (same
    # trick as _profile_q_setup's f0); lo_of(0) == 0 always
    lo0 = lo_of(jnp.int32(0))
    _, outs = jax.lax.scan(block, (h0_loc, f0_loc, lo0), xs)

    h_at = (outs[1] if emit_ptr else outs).reshape(Mp, B)
    h0_at = jnp.take_along_axis(h0, ql[:, None], axis=1)[:, 0]
    h_all = jnp.concatenate([h0_at[None], h_at], axis=0)
    score = jnp.take_along_axis(h_all, p_len[None, :].astype(jnp.int32),
                                axis=0)[0]

    # optimality certificate (see block comment above).  The gap-cost
    # term uses ORDER STATISTICS, not a global occ_min: an outside path
    # makes >= g_lb gap moves on DISTINCT rows/columns, so its gap cost
    # is bounded by the sum of the g_lb LEAST-NEGATIVE per-row/column
    # extend costs (ext*occ).  One [B, M+N] sort; a single gap-heavy
    # column no longer sinks the whole window's certificate (the r5
    # refine gate measured 25% fallback under the occ_min bound).
    m_rows = jnp.arange(Mp)[None, :] < p_len[:, None]
    n_cols = jnp.arange(N)[None, :] < ql[:, None]
    cost_p = jnp.where(m_rows, gap_extend * (1.0 - p[:, :, GAP_CODE]),
                       -jnp.inf)
    cost_q = jnp.where(n_cols, gap_extend * (1.0 - q[:, :, GAP_CODE]),
                       -jnp.inf)
    costs = jnp.concatenate([cost_p, cost_q], axis=1)   # [B, Mp+N]
    costs = -jax.lax.sort(-costs, dimension=1)          # descending
    csum = jnp.cumsum(jnp.where(jnp.isfinite(costs), costs, 0.0),
                      axis=1)
    g_lb = jnp.maximum(2 * H_W - 3 * jnp.abs(ql - p_len), 0)
    gidx = jnp.clip(g_lb - 1, 0, Mp + N - 1).astype(jnp.int32)
    gap_bound = jnp.where(
        g_lb > 0,
        jnp.take_along_axis(csum, gidx[:, None], axis=1)[:, 0], 0.0)
    cap = jnp.maximum(qw.max(axis=2), 0.0)
    sumcap = jnp.where(n_cols, cap, 0.0).sum(axis=1)
    rhs = sumcap + gap_open + gap_bound
    cert = score > rhs + BAND_MARGIN
    return score, outs, cert


@functools.partial(jax.jit, static_argnums=(4, 5, 6))
def _banded_forward_scores(p, q, p_len, q_len, gap_open: int,
                           gap_extend: int, H_W: int):
    """Banded forward-only DP: (score float32[B], certified bool[B]).
    Scores of uncertified elements are lower bounds only — callers must
    re-run those at full width."""
    score, _, cert = _banded_block_scan(p, q, p_len, q_len, gap_open,
                                        gap_extend, H_W, False)
    return score, cert


@functools.partial(jax.jit, static_argnums=(4, 5, 6, 7))
def _banded_fwd_tb(p, q, p_len, q_len, gap_open: int, gap_extend: int,
                   H_W: int, T: int):
    """Banded forward + banded pointer tensor + on-device traceback
    walk.  Returns (score, cert, packed bit rows a la _device_tb_scan).
    Tracebacks of certified elements are byte-identical to the
    full-width DP's; uncertified ones are garbage and must re-run."""
    score, outs, cert = _banded_block_scan(p, q, p_len, q_len, gap_open,
                                           gap_extend, H_W, True)
    ptrs = outs[0]                       # [nb, K, B, WB+1]
    nbk, K, B, W1 = ptrs.shape
    ptrs = jnp.transpose(ptrs.reshape(nbk * K, B, W1), (1, 0, 2))
    N = q.shape[1]
    WB = W1 - 1
    M = nbk * K
    flat = ptrs.reshape(B, M * W1)
    lo_cap = max(N - WB, 0)
    pl = jnp.maximum(p_len, 1).astype(jnp.int32)
    ql = q_len.astype(jnp.int32)
    i0 = p_len.astype(jnp.int32)
    j0 = ql
    st0 = jnp.zeros_like(i0)
    from libmems_tpu.ops.gapped import E_EXT_BIT, F_EXT_BIT

    def step(carry, _):
        i, j, st = carry
        active = (i > 0) | (j > 0)
        c0 = active & (i == 0)
        c1 = active & (i > 0) & (j == 0)
        c2 = active & (i > 0) & (j > 0)
        bi = jnp.maximum(i - 1, 0) // BAND_K
        lo = jnp.clip((bi * BAND_K * ql) // pl - (H_W + 1), 0, lo_cap)
        w = jnp.clip(j - lo, 0, WB)
        lin = jnp.clip((i - 1) * W1 + w, 0, M * W1 - 1)
        byte = jnp.take_along_axis(flat, lin[:, None], axis=1)[:, 0]
        was_h = c2 & (st == 0)
        was_e = c2 & (st == 1)
        was_f = c2 & (st == 2)
        newst = (byte & 3).astype(st.dtype)
        dm = was_h & (newst == 0)
        a_gap = c0 | was_e
        b_gap = c1 | was_f
        emitted = c0 | c1 | dm | was_e | was_f
        i = i - (c1 | dm | was_f).astype(i.dtype)
        j = j - (c0 | dm | was_e).astype(j.dtype)
        st = jnp.where(was_h, newst,
                       jnp.where(was_e,
                                 jnp.where((byte & E_EXT_BIT) != 0, 1, 0),
                                 jnp.where(was_f,
                                           jnp.where((byte & F_EXT_BIT)
                                                     != 0, 2, 0), st)))
        return (i, j, st), (emitted, a_gap, b_gap)

    _, (steps, agaps, bgaps) = jax.lax.scan(
        step, (i0, j0, st0), None, length=T)
    pack = lambda x: jnp.packbits(x.astype(jnp.uint8), axis=0)
    return score, cert, (pack(steps), pack(agaps), pack(bgaps))


def _shard_banded_fwd_tb(mesh, gap_open, gap_extend, H_W, T):
    from jax.sharding import PartitionSpec as P

    def f(p, q, p_len, q_len):
        return _banded_fwd_tb(p, q, p_len, q_len, gap_open, gap_extend,
                              H_W, T)

    return jax.shard_map(
        f, mesh=mesh, in_specs=(P(_DP_AXIS),) * 4,
        out_specs=(P(_DP_AXIS), P(_DP_AXIS), (P(None, _DP_AXIS),) * 3))


def _shard_banded_scores(mesh, gap_open, gap_extend, H_W):
    from jax.sharding import PartitionSpec as P

    def f(p, q, p_len, q_len):
        return _banded_forward_scores(p, q, p_len, q_len, gap_open,
                                      gap_extend, H_W)

    return jax.shard_map(
        f, mesh=mesh, in_specs=(P(_DP_AXIS),) * 4,
        out_specs=(P(_DP_AXIS), P(_DP_AXIS)))


def _band_eligible(p_len: np.ndarray, q_len: np.ndarray,
                   M: int, N: int) -> np.ndarray:
    """Host-side banding eligibility per batch element (the kernel runs
    on the whole padded batch; ineligible rows are just never trusted)."""
    if N < BAND_MIN_N or M < 2 * BAND_K or _band_wb(N) + 1 >= N:
        return np.zeros(len(p_len), dtype=bool)
    pl = p_len.astype(np.int64)
    ql = q_len.astype(np.int64)
    return (pl > 0) & (ql > 0) & (ql <= BAND_SMAX * pl)


def _bucket_cols(n, minimum=16):
    """Padded column bucket: 4x-spaced below 1024 (per-call overhead
    dominates padding waste for small windows), 1.5x-spaced above.  The
    forward scan is one sequential step per row, so padded ROWS cost
    wall-clock: the finer spacing above 1024 cuts scan steps up to ~40%
    for 1-2.5k-row windows; extra buckets only cost one-time compiles."""
    b = minimum
    while b < n and b < 1024:
        b *= 4
    while b < n:
        b = b * 3 // 2
    return b


def profile_scores_batch(p_rows: list[np.ndarray],
                         q_rows: list[np.ndarray],
                         gap_open: int = GAP_OPEN,
                         gap_extend: int = GAP_EXTEND) -> np.ndarray:
    """Forward-only DP scores of many (p, q) profile pairs — no
    checkpoints kept (K = M: the scan carries one row), no traceback,
    only a float32[B] fetch.

    The gate for score-gated refinement (msa.refine_windows): tracebacks
    hold and transfer packed pointers at DP-cells/2 bytes, which at
    refine-window scale is GBs, so the expensive traceback runs
    ONLY for pairs whose optimal score beats their current alignment's
    path score (PERF.md rule 20)."""
    B = len(p_rows)
    if B == 0:
        return np.zeros(0, np.float64)
    out = np.zeros(B, dtype=np.float64)
    buckets: dict[tuple[int, int], list[int]] = {}
    for k in range(B):
        key = (_bucket_cols(p_rows[k].shape[1]),
               _bucket_cols(q_rows[k].shape[1]))
        buckets.setdefault(key, []).append(k)

    def do_bucket(item):
        (M, N), idxs = item
        Mp = -(-M // CKPT_ROWS) * CKPT_ROWS

        def build(sub):
            nbp = _bucket_cols(len(sub), 4)
            p = np.zeros((nbp, Mp, 5), dtype=np.float32)
            q = np.zeros((nbp, N, 5), dtype=np.float32)
            p_len = np.zeros(nbp, dtype=np.int32)
            q_len = np.zeros(nbp, dtype=np.int32)
            for r, k in enumerate(sub):
                cp, cq = p_rows[k].shape[1], q_rows[k].shape[1]
                p[r, :cp] = rows_to_profile(p_rows[k])
                q[r, :cq] = rows_to_profile(q_rows[k])
                p_len[r], q_len[r] = cp, cq
            return p, q, p_len, q_len

        todo = list(idxs)
        p, q, p_len, q_len = build(todo)
        if _band_eligible(p_len[:len(todo)], q_len[:len(todo)],
                          Mp, N).any():
            score_b, cert = _banded_forward_scores(
                jnp.asarray(p), jnp.asarray(q), jnp.asarray(p_len),
                jnp.asarray(q_len), gap_open, gap_extend, _band_half(N))
            okm = _band_eligible(p_len, q_len, Mp, N) & np.asarray(cert)
            _band_note(_band_eligible(p_len, q_len, Mp, N), okm,
                       len(todo))
            sb = np.asarray(score_b)
            remaining = []
            for r, k in enumerate(todo):
                if okm[r]:
                    out[k] = float(sb[r])
                else:
                    remaining.append(k)
            if not remaining:
                return
            todo = remaining
            p, q, p_len, q_len = build(todo)
        score, _, _ = profile_forward_ckpt(
            jnp.asarray(p), jnp.asarray(q), jnp.asarray(p_len),
            jnp.asarray(q_len), gap_open, gap_extend, Mp)
        s = np.asarray(score)
        for r, k in enumerate(todo):
            out[k] = float(s[r])

    _map_buckets(do_bucket, buckets)
    return out


def _map_buckets(fn, buckets: dict):
    """Run per-bucket work concurrently, so one bucket's host work and
    first-call compile overlap another's device work.  Buckets write
    disjoint result indices, so threading is safe.

    Under multi-host (jax.distributed) execution the buckets run
    SERIALLY: the bucket kernels are shard_map programs over a mesh
    spanning every process, and per-process thread scheduling could
    enqueue those cross-host SPMD programs in different orders on
    different processes — a deadlock.  Single-controller enqueue order
    is deterministic either way."""
    items = list(buckets.items())
    if len(items) <= 1 or jax.process_count() > 1:
        for it in items:
            fn(it)
        return
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=min(len(items), 4)) as ex:
        # materialize to surface exceptions
        list(ex.map(fn, items))


def profile_path_score(p_rows: np.ndarray, q_rows: np.ndarray,
                       gap_open: int = GAP_OPEN,
                       gap_extend: int = GAP_EXTEND) -> float:
    """DP-objective score of the CURRENT alignment of two row groups
    (the path the existing merged columns describe), under exactly the
    model profile_forward_ckpt optimizes: expected-W5 substitution on
    both-present columns, affine gaps with occupancy-scaled extends.
    profile_scores_batch(optimal) <= this + tol  <=>  the DP cannot
    improve the pair, so its traceback can be skipped."""
    p_present = (p_rows != GAP_CODE).any(axis=0)
    q_present = (q_rows != GAP_CODE).any(axis=0)
    keep = p_present | q_present
    p_prof = rows_to_profile(p_rows)[keep]          # [C, 5]
    q_prof = rows_to_profile(q_rows)[keep]
    p_present = p_present[keep]
    q_present = q_present[keep]
    diag = p_present & q_present
    w = W5.astype(np.float64)
    sub = float(np.einsum("cx,xy,cy->", p_prof[diag].astype(np.float64),
                          w, q_prof[diag].astype(np.float64)))
    ext_p = gap_extend * (1.0 - p_prof[:, GAP_CODE].astype(np.float64))
    ext_q = gap_extend * (1.0 - q_prof[:, GAP_CODE].astype(np.float64))
    f_move = p_present & ~q_present     # consume p col, gap in q
    e_move = q_present & ~p_present
    gaps = 0.0
    for move, ext in ((f_move, ext_p), (e_move, ext_q)):
        opens = int((move & ~np.concatenate([[False], move[:-1]])).sum())
        gaps += opens * gap_open + float(ext[move].sum())
    return sub + gaps


def profile_path_scores_single(rows: np.ndarray,
                               gap_open: int = GAP_OPEN,
                               gap_extend: int = GAP_EXTEND
                               ) -> np.ndarray:
    """Path scores of ALL G single-row bipartitions of one window in one
    vectorized pass: float64[G], entry g equal (to fp-summation order)
    to profile_path_score(rows[g:g+1], rows[others]).

    The refinement gate calls the path score for every (window, row)
    pair; the generic function rebuilds the (G-1)-row profile per call,
    so a G-row window paid ~G^2 column passes.  Here the column count
    matrix and its W5 contraction are computed once and each row's score
    falls out of count arithmetic (the per-process host budget is 2
    cores on this machine — numpy asymptotics, not parallelism, is the
    lever; PERF.md rule 15)."""
    G, C = rows.shape
    if G < 2 or C == 0:
        return np.zeros(G, dtype=np.float64)
    w = W5.astype(np.float64)
    # column counts over all rows
    cnt = np.zeros((5, C), dtype=np.int64)
    for a in range(5):
        cnt[a] = (rows == a).sum(axis=0)
    nongap = (G - cnt[GAP_CODE]).astype(np.int64)     # non-gap rows/col
    t = w @ cnt.astype(np.float64)                    # [5, C]
    wdiag = np.diag(w)                                # [5]
    inv = 1.0 / (G - 1)
    col = np.arange(C)

    out = np.empty(G, dtype=np.float64)
    for g in range(G):
        rg = rows[g]
        p_present = rg != GAP_CODE
        q_present = (nongap - p_present) > 0
        keep = p_present | q_present
        diag = p_present & q_present
        # substitution: one-hot p row against the others' count profile
        tg = t[rg, col] - wdiag[rg]
        sub = float((tg[diag]).sum() * inv)
        # affine gaps on kept columns (runs merge across dropped cols)
        f_move = (p_present & ~q_present)[keep]
        e_move = (~p_present & q_present)[keep]
        opens = int((f_move & ~np.concatenate([[False],
                                               f_move[:-1]])).sum()) \
            + int((e_move & ~np.concatenate([[False],
                                             e_move[:-1]])).sum())
        # ext_p = gap_extend at f_move cols (p is one-hot non-gap there)
        gaps = opens * gap_open + gap_extend * float(f_move.sum())
        # ext_q = gap_extend * (1 - others_gap/(G-1)); at e_move columns
        # p is a gap, so others_gap = total_gap - 1
        e_cols = (~p_present & q_present)
        if e_cols.any():
            others_gap = cnt[GAP_CODE][e_cols] - 1
            gaps += gap_extend * float(
                (1.0 - others_gap.astype(np.float64) * inv).sum())
        out[g] = sub + gaps
    return out


def align_profile_batch(p_rows: list[np.ndarray], q_rows: list[np.ndarray],
                        gap_open: int = GAP_OPEN,
                        gap_extend: int = GAP_EXTEND,
                        mesh="auto"):
    """Align many (p, q) alignment-row groups on device.

    p_rows[k] / q_rows[k]: uint8[G_k, C_k] code rows (4 = gap).  Returns
    per pair merged rows uint8[Gp_k + Gq_k, C'_k].  Pairs are bucketed by
    padded column count to bound recompilation.

    With more than one device (mesh="auto" default), the batch axis is
    sharded over all devices via shard_map — the AlignLCBInParallel
    parallelism (Aligner.cpp:1293-1367) mapped onto the mesh instead of
    OpenMP threads.  Pass mesh=None to force single-device execution.
    """
    B = len(p_rows)
    if B == 0:
        return []
    if mesh == "auto":
        mesh = dp_mesh()
    n_dev = mesh.devices.size if mesh is not None else 1
    results: list = [None] * B

    buckets: dict[tuple[int, int], list[int]] = {}
    for k in range(B):
        key = (_bucket_cols(p_rows[k].shape[1]),
               _bucket_cols(q_rows[k].shape[1]))
        buckets.setdefault(key, []).append(k)

    from libmems_tpu.ops.gapped import traceback_blocks

    def do_bucket(item):
        (M, N), idxs = item
        K = min(CKPT_ROWS, M)
        Mp = -(-M // K) * K

        def build(sub):
            nbp = max(_bucket_cols(len(sub), 4), n_dev)
            p = np.zeros((nbp, Mp, 5), dtype=np.float32)
            q = np.zeros((nbp, N, 5), dtype=np.float32)
            p_len = np.zeros(nbp, dtype=np.int32)
            q_len = np.zeros(nbp, dtype=np.int32)
            for r, k in enumerate(sub):
                cp, cq = p_rows[k].shape[1], q_rows[k].shape[1]
                p[r, :cp] = rows_to_profile(p_rows[k])
                q[r, :cq] = rows_to_profile(q_rows[k])
                p_len[r], q_len[r] = cp, cq
            return p, q, p_len, q_len, nbp

        from libmems_tpu.ops.gapped import (DEVICE_TB_BUDGET,
                                            _device_tb_T, tb_unpack)
        idxs = list(idxs)
        p, q, p_len, q_len, nbp = build(idxs)
        band_budget = nbp * Mp * (_band_wb(N) + 1) <= DEVICE_TB_BUDGET
        if band_budget and _band_eligible(p_len[:len(idxs)],
                                          q_len[:len(idxs)], Mp, N).any():
            # banded fast path: certified windows get byte-identical
            # tracebacks at a fraction of the DP cells; the rest re-run
            # at full width below
            H_W = _band_half(N)
            T = _device_tb_T(Mp, N)
            args = (jnp.asarray(p), jnp.asarray(q), jnp.asarray(p_len),
                    jnp.asarray(q_len))
            if mesh is not None:
                _, cert, packed = _shard_banded_fwd_tb(
                    mesh, gap_open, gap_extend, H_W, T)(*args)
            else:
                _, cert, packed = _banded_fwd_tb(
                    *args, gap_open, gap_extend, H_W, T)
            okm = _band_eligible(p_len, q_len, Mp, N) & np.asarray(cert)
            _band_note(_band_eligible(p_len, q_len, Mp, N), okm,
                       len(idxs))
            tb_b = tb_unpack(packed, nbp, T)
            remaining = []
            for r, k in enumerate(idxs):
                if okm[r]:
                    p_gaps, q_gaps = tb_b[r]
                    results[k] = merge_rows(p_rows[k], q_rows[k],
                                            p_gaps, q_gaps)
                else:
                    remaining.append(k)
            if not remaining:
                return
            idxs = remaining
            p, q, p_len, q_len, nbp = build(idxs)
        pj = jnp.asarray(p)
        qj = jnp.asarray(q)
        qlj = jnp.asarray(q_len)
        from libmems_tpu.ops.gapped import (DEVICE_TB_BUDGET,
                                            _device_tb_T, tb_unpack)
        if nbp * Mp * (N + 1) <= DEVICE_TB_BUDGET:
            T = _device_tb_T(Mp, N)
            ext_p = gap_extend * (1.0 - pj[:, :, GAP_CODE])
            plj = jnp.asarray(p_len)
            if mesh is not None:
                packed = _shard_full_tb(mesh, gap_open, gap_extend, T)(
                    pj, ext_p, qj, qlj, plj)
            else:
                packed = _full_ptr_tb_jit(pj, ext_p, qj, qlj, plj,
                                          gap_open, gap_extend, T)
            tb = tb_unpack(packed, nbp, T)
        else:
            if mesh is not None:
                fwd = _shard_forward(mesh, gap_open, gap_extend, K)
                ptrs_fn = _shard_ptrs(mesh, gap_open, gap_extend)
            else:
                def fwd(p_, q_, pl_, ql_):
                    return profile_forward_ckpt(p_, q_, pl_, ql_,
                                                gap_open, gap_extend, K)

                def ptrs_fn(*a):
                    return profile_block_ptrs(*a, gap_open, gap_extend)
            _, ck_h, ck_f = fwd(pj, qj, jnp.asarray(p_len), qlj)
            ext_p = gap_extend * (1.0 - pj[:, :, GAP_CODE])

            def fetch(bi, pj=pj, qj=qj, qlj=qlj, ck_h=ck_h, ck_f=ck_f,
                      ext_p=ext_p, K=K, N=N, ptrs_fn=ptrs_fn):
                from libmems_tpu.ops.gapped import pack_ptrs, unpack_ptrs
                return unpack_ptrs(np.asarray(pack_ptrs(ptrs_fn(
                    ck_h[bi], ck_f[bi], pj[:, bi * K:(bi + 1) * K],
                    ext_p[:, bi * K:(bi + 1) * K], qj, qlj))), N + 1)

            tb = traceback_blocks(fetch, Mp // K, K, p_len, q_len)
        for r, k in enumerate(idxs):
            p_gaps, q_gaps = tb[r]
            results[k] = merge_rows(p_rows[k], q_rows[k], p_gaps, q_gaps)

    _map_buckets(do_bucket, buckets)
    return results


def merge_rows(p_rows: np.ndarray, q_rows: np.ndarray,
               p_gaps: np.ndarray, q_gaps: np.ndarray) -> np.ndarray:
    """Interleave two row groups along the merged column axis given their
    gap masks (True = insert an all-gap column on that side)."""
    C = len(p_gaps)
    Gp, Gq = p_rows.shape[0], q_rows.shape[0]
    out = np.full((Gp + Gq, C), GAP_CODE, dtype=np.uint8)
    out[:Gp, ~p_gaps] = p_rows
    out[Gp:, ~q_gaps] = q_rows
    return out
