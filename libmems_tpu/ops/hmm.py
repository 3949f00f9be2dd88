"""Two-state homology pair-HMM: batched log-space forward/backward.

Batched device replacement for the HMMoC-generated HomologyHMM
(libMems/HomologyHMM/homology.{h,cc}, homology.xml, homologymain.cc):
states {homologous, unrelated} over 8 column-class symbols (identity
AT/GC, transversion/transition classes, gap open, gap extend —
parameters.h:24-47).  Where the reference runs one sequence at a time
with a custom extended-exponent float ("bfloat", algebras.h) to dodge
underflow, here whole batches of encoded column sequences run in one
`lax.scan` in log space (log-sum-exp replaces bfloat), and the posterior
threshold (≥ 0.9 ⇒ homologous, homologymain.cc:44-58) is a vector
compare.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from libmems_tpu import _jaxconfig  # noqa: F401

POSTERIOR_THRESHOLD = 0.9   # homologymain.cc:50


@dataclass
class HmmParams:
    """Transition + emission parameters (HomologyHMM Params struct)."""

    start_homologous: float = 0.5
    go_homologous: float = 1e-5          # U -> H
    go_unrelated: float = 1e-7           # H -> U
    go_stop_from_homologous: float = 1e-8
    go_stop_from_unrelated: float = 1e-8
    emit_homologous: np.ndarray = field(default=None)  # float[8]
    emit_unrelated: np.ndarray = field(default=None)


def hoxd_params() -> HmmParams:
    """The Chiaromonte/Miller HOXD-derived defaults
    (parameters.h getHoxdParams, :11-53)."""
    eh = np.zeros(8)
    eh[0] = 0.1723 * 2     # a:a, t:t
    eh[1] = 0.1462 * 2     # c:c, g:g
    eh[2] = 0.0180 * 4     # a:c class (transversion 1)
    eh[3] = 0.0426 * 4     # a:g class (transition)
    eh[4] = 0.0186 * 2     # a:t
    eh[5] = 0.0142 * 2     # g:c
    eh[6] = 0.004461       # gap open
    eh[7] = 1.0 - eh[:7].sum()   # gap extend
    eu = np.zeros(8)
    eu[0] = 0.12818742714404662781015820149872
    eu[1] = 0.10493347210657785179017485428807
    eu[2] = 0.11597910074937552039966694421313
    eu[3] = eu[2]
    eu[4] = eu[0]
    eu[5] = eu[1]
    eu[6] = 0.0483
    eu[7] = 1.0 - eu[:7].sum()
    return HmmParams(go_stop_from_homologous=1e-8,
                     go_stop_from_unrelated=1e-8,
                     emit_homologous=eh, emit_unrelated=eu)


def adapted_hoxd_params(gc_content: float) -> HmmParams:
    """GC-adapted emissions (getAdaptedHoxdMatrixParameters,
    parameters.h:59-137)."""
    at = 1.0 - gc_content
    gO_u, gE_u = 0.0483, 0.2535
    gO_h, gE_h = 0.004461, 0.050733
    eu = np.zeros(8)
    eu[0] = 2 * (at / 2) ** 2
    eu[1] = 2 * (gc_content / 2) ** 2
    eu[2] = 2 * (at / 2) * (gc_content / 2)
    eu[3] = eu[2]
    eu[4] = eu[0]
    eu[5] = eu[1]
    norm = (1 - (gO_u + gE_u)) / eu[:6].sum()
    eu[:6] *= norm
    eu[6] = gO_u
    eu[7] = 1.0 - eu[:7].sum()
    eh = np.zeros(8)
    eh[0] = (at / 0.525) * 0.1723 * 2
    eh[1] = (gc_content / 0.475) * 0.1462 * 2
    eh[2] = 0.0180 * 4
    eh[3] = 0.0426 * 4
    eh[4] = (at / 0.525) * 0.0186 * 2
    eh[5] = (gc_content / 0.475) * 0.0142 * 2
    norm = (1 - (gO_h + gE_h)) / eh[:6].sum()
    eh[:6] *= norm
    eh[6] = gO_h
    eh[7] = 1.0 - eh[:7].sum()
    return HmmParams(go_stop_from_homologous=1e-7,
                     go_stop_from_unrelated=1e-7,
                     emit_homologous=eh, emit_unrelated=eu)


def adapt_to_percent_identity(params: HmmParams,
                              pct_identity: float) -> HmmParams:
    """Shift homologous identity emission mass to match an expected
    percent identity (adaptToPercentIdentity, parameters.h:140-159)."""
    if not (0 < pct_identity <= 1):
        raise ValueError("bad pct identity")
    eh = params.emit_homologous.copy()
    gapnorm = pct_identity * (1.0 - eh[6] - eh[7])
    prev = eh[0] + eh[1]
    diff = prev - gapnorm
    rest = eh[2] + eh[3] + eh[4] + eh[5]
    eh[2:6] += diff * eh[2:6] / rest
    eh[0] -= diff * eh[0] / prev
    eh[1] -= diff * eh[1] / prev
    out = HmmParams(**{**params.__dict__})
    out.emit_homologous = eh
    return out


def _log_matrices(params: HmmParams):
    """(log_start[2], log_T[2,2], log_stop[2], log_emit[2,8]) with state
    order (H, U)."""
    lt = np.log(np.array([
        [1.0 - params.go_unrelated - params.go_stop_from_homologous,
         params.go_unrelated],
        [params.go_homologous,
         1.0 - params.go_homologous - params.go_stop_from_unrelated],
    ]))
    ls = np.log(np.array([params.start_homologous,
                          1.0 - params.start_homologous]))
    lstop = np.log(np.array([params.go_stop_from_homologous,
                             params.go_stop_from_unrelated]))
    le = np.log(np.stack([params.emit_homologous,
                          params.emit_unrelated]))
    return ls, lt, lstop, le


@functools.partial(jax.jit, static_argnums=())
def _fb_posterior(obs: jax.Array, lengths: jax.Array, ls, lt, lstop, le):
    """obs: int32[B, T] symbol codes 0..7 (padding arbitrary);
    lengths: int32[B].  Returns posterior P(H) float32[B, T]."""
    obs = obs.astype(jnp.int32)
    B, T = obs.shape
    le_obs = le.T[obs]                    # [B, T, 2] log emit per state
    idx = jnp.arange(T)

    def fstep(f_prev, x):
        le_i, i = x
        f = jax.nn.logsumexp(f_prev[:, :, None] + lt[None], axis=1) + le_i
        f = jnp.where((i < lengths)[:, None], f, f_prev)
        return f, f

    f0 = ls[None] + le_obs[:, 0]
    _, F = jax.lax.scan(fstep, f0,
                        (jnp.moveaxis(le_obs[:, 1:], 1, 0), idx[1:]))
    F = jnp.concatenate([f0[None], F], axis=0)      # [T, B, 2]

    def bstep(b_next, x):
        le_next, i = x
        b = jax.nn.logsumexp(
            lt[None] + (le_next + b_next)[:, None, :], axis=2)
        # positions at the end boundary take the stop vector
        b = jnp.where((i == lengths - 1)[:, None], lstop[None], b)
        b = jnp.where((i > lengths - 1)[:, None], b_next, b)
        return b, b

    bT = jnp.broadcast_to(lstop[None], (B, 2))
    _, Bk = jax.lax.scan(bstep, bT,
                         (jnp.moveaxis(le_obs[:, 1:], 1, 0), idx[:-1]),
                         reverse=True)
    Bk = jnp.concatenate([Bk, bT[None]], axis=0)    # [T, B, 2]

    last = jnp.take_along_axis(
        F, (lengths - 1)[None, :, None].astype(jnp.int32), axis=0)[0]
    logP = jax.nn.logsumexp(last + lstop[None], axis=1)    # [B]
    post_h = jnp.exp(F[:, :, 0] + Bk[:, :, 0] - logP[None, :])
    return jnp.moveaxis(post_h, 0, 1)               # [B, T]


FB_CKPT_COLS = 1024        # block size of the checkpointed F/B
_FB_CKPT_MIN_T = 1 << 14   # below this the un-blocked scan is cheaper
# cap B*T per dispatch (bounds the device live set); route-only, set on
# earlier hardware, re-tune on the GPU (ROADMAP)
_FB_MAX_ELEMS = 1 << 27


@functools.partial(jax.jit, static_argnums=(6,))
def _fb_posterior_ckpt(obs: jax.Array, lengths: jax.Array,
                       ls, lt, lstop, le, K: int):
    """Memory-bounded forward/backward: the un-blocked scan materializes
    O(T·B) per-state tables several times over — 16G+ HBM at 2M-column
    alignments.  Here the forward pass stores only per-block boundary
    carries (the row-checkpoint scheme of ops.gapped); the backward
    sweep re-derives each block's forward rows from its checkpoint, so
    live memory is O(B·(T/K + K)) plus the posterior output itself.

    Carry formulation: g_i = log P(obs[<i], state entering column i)
    (g_0 = log start), so f_i = g_i + logemit_i needs no ragged-length
    masking — f at each row's final column is tracked explicitly."""
    obs = obs.astype(jnp.int32)
    B, T = obs.shape
    nb = T // K
    le_t = le.T                                  # [8, 2]
    idxK = jnp.arange(K)

    obs_b = jnp.moveaxis(obs, 1, 0).reshape(nb, K, B)
    # column i+1 symbols, for the backward emission term
    obs_next = jnp.concatenate([obs[:, 1:], obs[:, :1]], axis=1)
    obs_nb = jnp.moveaxis(obs_next, 1, 0).reshape(nb, K, B)

    def fstep(c, x):
        g, f_last = c
        ob, i = x
        f = g + le_t[ob]
        f_last = jnp.where((i == lengths - 1)[:, None], f, f_last)
        g2 = jax.nn.logsumexp(f[:, :, None] + lt[None], axis=1)
        return (g2, f_last), None

    def fblock(carry, xs):
        obs_blk, i0 = xs
        ck = carry[0]
        c2, _ = jax.lax.scan(fstep, carry, (obs_blk, i0 + idxK))
        return c2, ck

    g0 = jnp.broadcast_to(ls[None], (B, 2))
    f_last0 = jnp.full((B, 2), -jnp.inf)
    (gT, f_last), g_cks = jax.lax.scan(
        fblock, (g0, f_last0),
        (obs_b, (jnp.arange(nb) * K).astype(jnp.int32)))
    logP = jax.nn.logsumexp(f_last + lstop[None], axis=1)     # [B]

    def bblock(b_carry, xs):
        g_ck, obs_blk, obs_nblk, i0 = xs

        def fstep2(g, x):
            ob, i = x
            f = g + le_t[ob]
            g2 = jax.nn.logsumexp(f[:, :, None] + lt[None], axis=1)
            return g2, f

        _, F_blk = jax.lax.scan(fstep2, g_ck, (obs_blk, i0 + idxK))

        def bstep(bn, x):
            ob_next, i = x
            le_next = le_t[ob_next]
            b = jax.nn.logsumexp(
                lt[None] + (le_next + bn)[:, None, :], axis=2)
            b = jnp.where((i == lengths - 1)[:, None], lstop[None], b)
            b = jnp.where((i > lengths - 1)[:, None], bn, b)
            return b, b

        b2, B_blk = jax.lax.scan(bstep, b_carry,
                                 (obs_nblk, i0 + idxK), reverse=True)
        post = jnp.exp(F_blk[:, :, 0] + B_blk[:, :, 0] - logP[None, :])
        return b2, post

    b_init = jnp.broadcast_to(lstop[None], (B, 2))
    _, posts = jax.lax.scan(
        bblock, b_init,
        (g_cks, obs_b, obs_nb, (jnp.arange(nb) * K).astype(jnp.int32)),
        reverse=True)
    return jnp.moveaxis(posts.reshape(T, B), 0, 1)            # [B, T]


# associative-scan F/B: above this length the sequential scan is
# latency-bound (a 1M-column alignment runs a 1M-step device loop of
# [B,2] work); the log-depth prefix-product formulation (SURVEY M6)
# touches O(T) 2x2 log-matrices across 2*log2(T) levels instead
_FB_ASSOC_MIN_T = 1 << 17
# B*T cap for the assoc path: it materializes [B, T, 2, 2] transfer
# tensors (16 bytes/column), so the cap is tighter than the scan path's
_FB_ASSOC_MAX_ELEMS = 1 << 24


def _lmm2(a, b):
    """Log-space 2x2 matmul with the matrix stored as FOUR [B, T]
    planes (m00, m01, m10, m11), so every operand is a plain [B, T]
    array with no tiny trailing dimensions."""
    a00, a01, a10, a11 = a
    b00, b01, b10, b11 = b
    return (jnp.logaddexp(a00 + b00, a01 + b10),
            jnp.logaddexp(a00 + b01, a01 + b11),
            jnp.logaddexp(a10 + b00, a11 + b10),
            jnp.logaddexp(a10 + b01, a11 + b11))


def _lmm2_rev(later, earlier):
    return _lmm2(earlier, later)


def _lnorm(m):
    """Shift a log-space 2x2 matrix (four planes) so its largest entry
    is 0."""
    c = jnp.maximum(jnp.maximum(m[0], m[1]), jnp.maximum(m[2], m[3]))
    return tuple(x - c for x in m)


FB_ASSOC_BLOCK = 4096   # columns per associative block: a single
                        # T-length associative_scan emits a 2*log2(T)-
                        # level unrolled HLO that compiles for a very
                        # long time at T=1M; two levels (blocks, then
                        # block totals) keep the HLO small


@functools.partial(jax.jit, static_argnums=(6,))
def _fb_calls_assoc(obs: jax.Array, lengths: jax.Array, ls, lt, lstop,
                    le, threshold: float):
    """Posterior>=threshold calls via block-associative prefix/suffix
    products of per-column transfer matrices.

    Forward: g_{i+1} = g_i (logmatmul) M_i with M_i[k,j] =
    le(obs_i)[k] + lt[k,j]; padding columns carry the log-identity so g
    freezes past each row's length.  Backward mirrors it with
    N_i[k,j] = lt[k,j] + le(obs_{i+1})[j], identity from column
    length-1 on, so the recursion equals the sequential scan exactly
    (up to f32 reassociation).  Each FB_ASSOC_BLOCK-column block runs
    one log-depth associative scan over four [B, K] planes, block
    totals get their own small associative scan, and a vectorized
    combine recovers every column.

    Every matrix is shifted so its largest entry is 0 before it is
    multiplied, and the posterior is normalized per column: the shifts
    add the same scalar to both states of a column, so they cancel,
    while the log-values stay near 0 instead of growing with the column
    index (in float32 an unnormalized log-likelihood of a megabase row
    is ~1e6, whose rounding alone moves posteriors by tens of percent).
    Returns bit-packed calls uint8[B, T/8]."""
    B, T = obs.shape
    K = min(FB_ASSOC_BLOCK, T)
    nb = T // K
    # float32 throughout (f64 slowed execution and compile time at
    # megabase shapes); posterior>=0.9 calls are insensitive at this
    # precision (borderline columns excluded in the parity tests move
    # either way)
    ls = jnp.asarray(ls, jnp.float32)
    lt = jnp.asarray(lt, jnp.float32)
    lstop = jnp.asarray(lstop, jnp.float32)
    obs = obs.astype(jnp.int32)
    le = jnp.asarray(le, jnp.float32)
    le0 = le[0][obs]                                # [B, T] emit | H
    le1 = le[1][obs]                                # [B, T] emit | U
    idx = jnp.arange(T)
    valid = idx[None, :] < lengths[:, None]
    ninf = jnp.float32(-jnp.inf)

    def planes(e0, e1, mask, row_is_emit):
        """Transfer planes with identity at masked columns.
        row_is_emit: forward matrices add the emission to the ROW
        (M[k,j] = e_k + lt[k,j]); backward to the COLUMN."""
        if row_is_emit:
            m = (e0 + lt[0, 0], e0 + lt[0, 1],
                 e1 + lt[1, 0], e1 + lt[1, 1])
        else:
            m = (e0 + lt[0, 0], e1 + lt[0, 1],
                 e0 + lt[1, 0], e1 + lt[1, 1])
        return (jnp.where(mask, 0.0, m[0]), jnp.where(mask, ninf, m[1]),
                jnp.where(mask, ninf, m[2]), jnp.where(mask, 0.0, m[3]))

    def blk(x):                                     # [B, T] -> [B*nb, K]
        return x.reshape(B * nb, K)

    le0n = jnp.concatenate([le0[:, 1:], le0[:, :1]], axis=1)
    le1n = jnp.concatenate([le1[:, 1:], le1[:, :1]], axis=1)
    lastcol = idx[None, :] >= (lengths - 1)[:, None]

    # ---- forward: one K-length associative scan with blocks MERGED
    # into the batch axis (no outer while loop — the toolchain's
    # compile time explodes when the log-depth scan sits inside a
    # lax.scan body), then a tiny nb-length scan over block totals,
    # then a vectorized combine.
    M = _lnorm(planes(blk(le0), blk(le1), blk(~valid), True))
    P = jax.lax.associative_scan(_lmm2, M, axis=1)   # within-block prefix
    Q = _lnorm(tuple(p.reshape(B, nb, K)[:, :, -1] for p in P))  # totals
    # block-start carries: g_b = ls (x) Q_0 (x) ... (x) Q_{b-1}
    Qp = jax.lax.associative_scan(_lmm2, Q, axis=1)  # inclusive over nb
    gs0 = jnp.logaddexp(ls[0] + Qp[0], ls[1] + Qp[2])     # [B, nb]
    gs1 = jnp.logaddexp(ls[0] + Qp[1], ls[1] + Qp[3])
    g_start0 = jnp.concatenate(
        [jnp.zeros((B, 1), le0.dtype) + ls[0], gs0[:, :-1]], axis=1)
    g_start1 = jnp.concatenate(
        [jnp.zeros((B, 1), le0.dtype) + ls[1], gs1[:, :-1]], axis=1)
    # g at (block b, col i) = g_start_b for i==0 else g_start_b (x) P_{i-1}
    Pb = tuple(p.reshape(B, nb, K) for p in P)
    a0 = g_start0[:, :, None]
    a1 = g_start1[:, :, None]
    gn0 = jnp.logaddexp(a0 + Pb[0], a1 + Pb[2])       # [B, nb, K]
    gn1 = jnp.logaddexp(a0 + Pb[1], a1 + Pb[3])
    gc0 = jnp.concatenate([jnp.broadcast_to(a0, a0.shape),
                           gn0[:, :, :-1]], axis=2)
    gc1 = jnp.concatenate([jnp.broadcast_to(a1, a1.shape),
                           gn1[:, :, :-1]], axis=2)
    F0 = gc0.reshape(B, T) + le0
    F1 = gc1.reshape(B, T) + le1

    # ---- backward: within-block suffix products + suffix carries.  A
    # reverse associative_scan calls fn(later, earlier), so the product
    # N_i (x) N_{i+1} (x) ... needs the arguments swapped back
    N = _lnorm(planes(blk(le0n), blk(le1n), blk(lastcol), False))
    S = jax.lax.associative_scan(_lmm2_rev, N, axis=1, reverse=True)
    R = _lnorm(tuple(s.reshape(B, nb, K)[:, :, 0] for s in S))  # totals
    Rs = jax.lax.associative_scan(_lmm2_rev, R, axis=1, reverse=True)
    # b at the END of block b (column start of block b+1 - 1's next):
    # carry entering block b from the right = R_{b+1} (x) ... applied
    # to lstop; inclusive reverse scan Rs_b = R_b (x) ... (x) R_{nb-1}
    bs0 = jnp.logaddexp(Rs[0] + lstop[0], Rs[1] + lstop[1])   # [B, nb]
    bs1 = jnp.logaddexp(Rs[2] + lstop[0], Rs[3] + lstop[1])
    bc0 = jnp.concatenate(
        [bs0[:, 1:], jnp.zeros((B, 1), le0.dtype) + lstop[0]], axis=1)
    bc1 = jnp.concatenate(
        [bs1[:, 1:], jnp.zeros((B, 1), le0.dtype) + lstop[1]], axis=1)
    Sb = tuple(s.reshape(B, nb, K) for s in S)
    b0_all = jnp.logaddexp(Sb[0] + bc0[:, :, None],
                           Sb[1] + bc1[:, :, None]).reshape(B, T)
    b1_all = jnp.logaddexp(Sb[2] + bc0[:, :, None],
                           Sb[3] + bc1[:, :, None]).reshape(B, T)

    h = F0 + b0_all
    post_h = jnp.exp(h - jnp.logaddexp(h, F1 + b1_all))
    calls = ((post_h >= threshold) & valid).astype(jnp.uint8)
    return jnp.packbits(calls.reshape(B, T // 8, 8), axis=2,
                        bitorder="little")[:, :, 0]


def _fb_batched(sequences, params, fetch, max_elems_for=None):
    """Shared bucketing/padding driver: `fetch(obs, lens, matrices, T)`
    returns the per-dispatch host array; rows sliced back per input."""
    if params is None:
        params = hoxd_params()
    mats = tuple(jnp.asarray(x) for x in _log_matrices(params))
    out: list = [None] * len(sequences)
    empty: list[int] = []
    buckets: dict[int, list[int]] = {}
    for i, s in enumerate(sequences):
        if len(s) == 0:
            empty.append(i)
            continue
        T = max(64, 1 << (len(s) - 1).bit_length())
        buckets.setdefault(T, []).append(i)
    for T, idxs in buckets.items():
        cap = max_elems_for(T) if max_elems_for else _FB_MAX_ELEMS
        max_rows = max(1, cap // T)
        for base in range(0, len(idxs), max_rows):
            part = idxs[base:base + max_rows]
            Bp = max(1, 1 << (len(part) - 1).bit_length())
            if len(idxs) > max_rows:
                # multi-dispatch bucket: pad EVERY part (including the
                # remainder) to the full per-dispatch row count so a
                # different job count next run reuses one executable
                Bp = max(1, 1 << (max_rows - 1).bit_length())
            # int8 upload: symbols are 0..7, so one byte per column
            # moves a quarter of int32's bytes to the device; kernels
            # cast to int32 on device
            obs = np.zeros((Bp, T), dtype=np.int8)
            lens = np.ones(Bp, dtype=np.int32)
            for r, i in enumerate(part):
                obs[r, :len(sequences[i])] = sequences[i]
                lens[r] = len(sequences[i])
            res = fetch(jnp.asarray(obs), jnp.asarray(lens), mats, T)
            for r, i in enumerate(part):
                out[i] = res[r, :len(sequences[i])]
    return out, empty


def posterior_homologous(sequences: list[np.ndarray],
                         params: HmmParams | None = None) -> list[np.ndarray]:
    """Posterior P(homologous) per column for a batch of encoded symbol
    sequences (uint8 codes 0..7).  Batched, padded to buckets; long
    sequences run the checkpointed F/B, and each dispatch's B*T is
    capped so the HBM live set stays bounded at any alignment length."""

    def fetch(obs, lens, mats, T):
        if T >= _FB_CKPT_MIN_T:
            return np.asarray(_fb_posterior_ckpt(obs, lens, *mats,
                                                 FB_CKPT_COLS))
        return np.asarray(_fb_posterior(obs, lens, *mats))

    out, empty = _fb_batched(sequences, params, fetch)
    for i in empty:
        out[i] = np.zeros(0, dtype=np.float32)
    return out


@functools.partial(jax.jit, static_argnums=(6, 7))
def _fb_calls_ckpt(obs, lengths, ls, lt, lstop, le, K: int,
                   threshold: float):
    """Thresholded homology calls, packed 8 columns/byte ON DEVICE —
    the posterior itself never leaves the device (a 2M-column batch's
    float posteriors are hundreds of MB; packed calls are 1/32 of
    that)."""
    post = _fb_posterior_ckpt(obs, lengths, ls, lt, lstop, le, K)
    bits = (post >= threshold).astype(jnp.uint8)
    B, T = bits.shape
    return jnp.packbits(bits.reshape(B, T // 8, 8), axis=2,
                        bitorder="little")[:, :, 0]


@functools.partial(jax.jit, static_argnums=(6,))
def _fb_calls_small(obs, lengths, ls, lt, lstop, le, threshold: float):
    """Thresholded calls for small buckets, packed 8 columns/byte on
    device (the T < _FB_CKPT_MIN_T tier of predict_homologous; T is a
    power of two >= 64, so T % 8 == 0)."""
    post = _fb_posterior(obs, lengths, ls, lt, lstop, le)
    bits = (post >= threshold).astype(jnp.uint8)
    B, T = bits.shape
    return jnp.packbits(bits.reshape(B, T // 8, 8), axis=2,
                        bitorder="little")[:, :, 0]


def predict_homologous(sequences: list[np.ndarray],
                       params: HmmParams | None = None,
                       threshold: float = POSTERIOR_THRESHOLD
                       ) -> list[np.ndarray]:
    """Boolean per-column homology calls (run() equivalent).  Long
    sequences threshold + bit-pack on device and unpack host-side."""

    def fetch(obs, lens, mats, T):
        if T >= _FB_ASSOC_MIN_T:
            packed = _fb_calls_assoc(obs, lens, *mats, float(threshold))
        elif T >= _FB_CKPT_MIN_T:
            packed = _fb_calls_ckpt(obs, lens, *mats, FB_CKPT_COLS,
                                    float(threshold))
        else:
            # small buckets dominate backbone workloads (config 4:
            # mean interval ~4k columns, 36 pairs x 1M columns total);
            # their raw f32 posteriors are ~200 MB — threshold +
            # bit-pack on device for EVERY size (1/32 the bytes)
            packed = _fb_calls_small(obs, lens, *mats, float(threshold))
        return np.unpackbits(np.asarray(packed), axis=1,
                             bitorder="little").astype(bool)

    out, empty = _fb_batched(
        sequences, params, fetch,
        max_elems_for=lambda T: (_FB_ASSOC_MAX_ELEMS
                                 if T >= _FB_ASSOC_MIN_T
                                 else _FB_MAX_ELEMS))
    for i in empty:
        out[i] = np.zeros(0, dtype=bool)
    return out


# --------------------------------------------------------------------------
# Viterbi decoding + Baum-Welch re-estimation
# (the HMMoC xml also generates these: homology.h:178-184 declares
#  Viterbi_recurse/Viterbi_trace and BaumWelch counting; the reference
#  never calls them from libMems but ships them as public API)
# --------------------------------------------------------------------------

@jax.jit
def _viterbi_path(obs: jax.Array, lengths: jax.Array, ls, lt, lstop, le):
    """Batched max-product decode.  obs int32[B, T]; returns the most
    likely state per column, bool[B, T] (True = homologous)."""
    obs = obs.astype(jnp.int32)
    B, T = obs.shape
    le_obs = le.T[obs]                    # [B, T, 2]
    idx = jnp.arange(T)

    def vstep(v_prev, x):
        le_i, i = x
        cand = v_prev[:, :, None] + lt[None]       # [B, from, to]
        ptr = jnp.argmax(cand, axis=1)             # [B, 2]
        v = jnp.max(cand, axis=1) + le_i
        v = jnp.where((i < lengths)[:, None], v, v_prev)
        ptr = jnp.where((i < lengths)[:, None], ptr,
                        jnp.arange(2)[None, :])
        return v, (v, ptr)

    v0 = ls[None] + le_obs[:, 0]
    vT, (V, PTR) = jax.lax.scan(
        vstep, v0, (jnp.moveaxis(le_obs[:, 1:], 1, 0), idx[1:]))
    V = jnp.concatenate([v0[None], V], axis=0)      # [T, B, 2]
    PTR = jnp.concatenate(
        [jnp.broadcast_to(jnp.arange(2)[None, None, :], (1, B, 2)), PTR],
        axis=0)                                     # [T, B, 2]

    v_last = jnp.take_along_axis(
        V, (lengths - 1)[None, :, None].astype(jnp.int32), axis=0)[0]
    end_state = jnp.argmax(v_last + lstop[None], axis=1)  # [B]

    def tstep(state, ptr_i):
        # carry = state at column i; output it, step to column i-1.
        # Padding columns (i >= length) carry identity pointers, so the
        # traceback passes through them unchanged.
        prev = jnp.take_along_axis(ptr_i, state[:, None], axis=1)[:, 0]
        return prev, state

    s0, states = jax.lax.scan(tstep, end_state, PTR[1:], reverse=True)
    states = jnp.concatenate([s0[None], states], axis=0)   # [T, B]
    return jnp.moveaxis(states, 0, 1) == 0          # [B, T] True = H


def viterbi_homologous(sequences: list[np.ndarray],
                       params: HmmParams | None = None) -> list[np.ndarray]:
    """Most-likely state path per column (True = homologous) for a batch
    of encoded symbol sequences — the Viterbi analog of run()."""
    if params is None:
        params = hoxd_params()
    ls, lt, lstop, le = (jnp.asarray(x) for x in _log_matrices(params))
    out: list = [None] * len(sequences)
    buckets: dict[int, list[int]] = {}
    for i, s in enumerate(sequences):
        if len(s) == 0:
            out[i] = np.zeros(0, dtype=bool)
            continue
        T = max(64, 1 << (len(s) - 1).bit_length())
        buckets.setdefault(T, []).append(i)
    for T, idxs in buckets.items():
        Bp = max(1, 1 << (len(idxs) - 1).bit_length())
        obs = np.zeros((Bp, T), dtype=np.int8)
        lens = np.ones(Bp, dtype=np.int32)
        for r, i in enumerate(idxs):
            obs[r, :len(sequences[i])] = sequences[i]
            lens[r] = len(sequences[i])
        path = np.asarray(_viterbi_path(jnp.asarray(obs), jnp.asarray(lens),
                                        ls, lt, lstop, le))
        for r, i in enumerate(idxs):
            out[i] = path[r, :len(sequences[i])]
    return out


@jax.jit
def _bw_counts(obs: jax.Array, lengths: jax.Array, ls, lt, lstop, le):
    """Expected transition counts [2,2], start counts [2] and emission
    counts [2,8] for one padded batch (standard Baum-Welch E-step in log
    space, masked past each row's length)."""
    obs = obs.astype(jnp.int32)
    B, T = obs.shape
    le_obs = le.T[obs]
    idx = jnp.arange(T)

    def fstep(f_prev, x):
        le_i, i = x
        f = jax.nn.logsumexp(f_prev[:, :, None] + lt[None], axis=1) + le_i
        f = jnp.where((i < lengths)[:, None], f, f_prev)
        return f, f

    f0 = ls[None] + le_obs[:, 0]
    _, F = jax.lax.scan(fstep, f0,
                        (jnp.moveaxis(le_obs[:, 1:], 1, 0), idx[1:]))
    F = jnp.concatenate([f0[None], F], axis=0)

    def bstep(b_next, x):
        le_next, i = x
        b = jax.nn.logsumexp(
            lt[None] + (le_next + b_next)[:, None, :], axis=2)
        b = jnp.where((i == lengths - 1)[:, None], lstop[None], b)
        b = jnp.where((i > lengths - 1)[:, None], b_next, b)
        return b, b

    bT = jnp.broadcast_to(lstop[None], (B, 2))
    _, Bk = jax.lax.scan(bstep, bT,
                         (jnp.moveaxis(le_obs[:, 1:], 1, 0), idx[:-1]),
                         reverse=True)
    Bk = jnp.concatenate([Bk, bT[None]], axis=0)

    last = jnp.take_along_axis(
        F, (lengths - 1)[None, :, None].astype(jnp.int32), axis=0)[0]
    logP = jax.nn.logsumexp(last + lstop[None], axis=1)    # [B]

    gamma = jnp.exp(F + Bk - logP[None, :, None])          # [T, B, 2]
    col_mask = (idx[:, None] < lengths[None, :])           # [T, B]
    gamma = gamma * col_mask[:, :, None]

    # xi[t] for transitions t -> t+1 (t < length-1)
    le_b = jnp.moveaxis(le_obs, 1, 0) + Bk                 # [T, B, 2]
    xi = jnp.exp(F[:-1, :, :, None] + lt[None, None]
                 + le_b[1:, :, None, :] - logP[None, :, None, None])
    xi_mask = (idx[:-1, None] < lengths[None, :] - 1)
    xi = xi * xi_mask[:, :, None, None]
    trans_counts = xi.sum(axis=(0, 1))                     # [2, 2]

    onehot = jax.nn.one_hot(obs, 8, dtype=gamma.dtype)     # [B, T, 8]
    emit_counts = jnp.einsum("tbs,bto->so",
                             gamma, onehot * col_mask.T[:, :, None],
                             precision=jax.lax.Precision.HIGHEST)
    start_counts = gamma[0].sum(axis=0)
    return start_counts, trans_counts, emit_counts, logP.sum()


def baum_welch(sequences: list[np.ndarray],
               params: HmmParams | None = None,
               iterations: int = 5,
               pseudocount: float = 1e-3
               ) -> tuple[HmmParams, list[float]]:
    """Baum-Welch EM re-estimation of emissions and H<->U transitions
    from a corpus of encoded column sequences.  Returns (fitted params,
    per-iteration total log-likelihood).  Stop probabilities are held
    fixed (they encode sequence-end modelling, parameters.h:18-21)."""
    if params is None:
        params = hoxd_params()
    params = HmmParams(**{**params.__dict__})
    seqs = [s for s in sequences if len(s) > 0]
    if not seqs:
        return params, []
    T = max(64, 1 << (max(len(s) for s in seqs) - 1).bit_length())
    Bp = max(1, 1 << (len(seqs) - 1).bit_length())
    obs = np.zeros((Bp, T), dtype=np.int8)
    lens = np.ones(Bp, dtype=np.int32)
    for r, s in enumerate(seqs):
        obs[r, :len(s)] = s
        lens[r] = len(s)
    # padding rows replicate row 0 with length 1; subtract their counts
    obs_j, lens_j = jnp.asarray(obs), jnp.asarray(lens)
    n_pad = Bp - len(seqs)
    lls: list[float] = []
    for _ in range(iterations):
        ls, lt, lstop, le = (jnp.asarray(x) for x in _log_matrices(params))
        sc, tc, ec, ll = (np.array(x) for x in _bw_counts(
            obs_j, lens_j, ls, lt, lstop, le))
        if n_pad:
            # each pad row is a length-1 symbol-0 sequence: its gamma adds
            # start/emission mass but no transitions
            ls_np, _, lstop_np, le_np = _log_matrices(params)
            g0 = np.exp(ls_np + le_np[:, 0] + lstop_np)
            g0 = g0 / g0.sum()
            sc = sc - n_pad * g0
            ec[:, 0] = ec[:, 0] - n_pad * g0
            ll = ll - n_pad * float(
                np.log(np.exp(ls_np + le_np[:, 0] + lstop_np).sum()))
        lls.append(float(ll))
        sc = np.maximum(sc, 0) + pseudocount
        tc = np.maximum(tc, 0) + pseudocount
        ec = np.maximum(ec, 0) + pseudocount
        params.start_homologous = float(sc[0] / sc.sum())
        # row-normalize transitions, preserving the fixed stop mass
        stop = np.array([params.go_stop_from_homologous,
                         params.go_stop_from_unrelated])
        tnorm = tc / tc.sum(axis=1, keepdims=True) * (1.0 - stop)[:, None]
        params.go_unrelated = float(tnorm[0, 1])
        params.go_homologous = float(tnorm[1, 0])
        enorm = ec / ec.sum(axis=1, keepdims=True)
        params.emit_homologous = enorm[0]
        params.emit_unrelated = enorm[1]
    return params, lls
