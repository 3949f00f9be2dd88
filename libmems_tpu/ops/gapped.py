"""Batched pairwise global alignment with affine gaps (Gotoh DP).

Batched device replacement for the reference's in-process MUSCLE calls on
inter-anchor gap regions (MuscleInterface::Align / CallMuscleFast,
libMems/MuscleInterface.cpp:428-521,:727-769).  Scoring follows the
reference's defaults: HOXD70 substitution matrix, gap open -400, gap
extend -30 (libMems/SubstitutionMatrix.h:23-35).

Design: one `lax.scan` over rows of the DP matrix; the within-row
horizontal dependency of the gap matrix E is resolved with the max-plus
prefix trick (E[j] = ext*j + cummax_{k<j}(G[k] + open - ext*k)), so each
row is pure vector work over (batch, N) — no sequential inner loop.

Memory is bounded by ROW CHECKPOINTING instead of a full [B, M, N+1]
pointer matrix: the forward pass stores the (H, F) carry every K rows
(O(B·M/K·N)); the traceback walks blocks of K rows from the bottom,
re-deriving each block's packed pointer bytes on device from its
checkpoint (O(B·K·N) live) and stepping ALL pairs of the batch in
lockstep with vectorized numpy (no per-cell Python inner loop per
pair).  Results are bit-identical to the full-pointer formulation; a
10k x 10k window costs ~7.5 MB/pair instead of ~100 MB.

Alignment content differs from MUSCLE's (different algorithm); anchor
coordinates and XMFA structure are unaffected — parity with the
reference is defined at the anchor framework level (SURVEY.md M4).
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

from libmems_tpu import _jaxconfig  # noqa: F401

# HOXD70 (A,C,G,T), libMems/SubstitutionMatrix.h:23-32
HOXD70 = np.array([
    [91, -114, -31, -123],
    [-114, 100, -125, -31],
    [-31, -125, 100, -114],
    [-123, -31, -114, 91],
], dtype=np.int32)
GAP_OPEN = -400    # SubstitutionMatrix.h:34
GAP_EXTEND = -30   # SubstitutionMatrix.h:35

NEG_INF = np.int32(-(1 << 30))


def read_substitution_matrix(path_or_fh) -> np.ndarray:
    """Parse the reference's substitution-matrix file format
    (readSubstitutionMatrix, libMems/SubstitutionMatrix.h:76-107):
    one header line, an 'A C G T N' column-label line, then four rows
    of 'letter s(A) s(C) s(G) s(T) s(N)' (the N column is ignored).
    Returns int32[4, 4]."""
    import os
    own = isinstance(path_or_fh, (str, os.PathLike))
    fh = open(path_or_fh) if own else path_or_fh
    try:
        fh.readline()                       # header info
        labels = fh.readline().split()
        if labels[:5] != ["A", "C", "G", "T", "N"]:
            raise ValueError("Invalid substitution matrix format")
        out = np.zeros((4, 4), dtype=np.int32)
        for i in range(4):
            tok = fh.readline().split()
            out[i] = [int(x) for x in tok[1:5]]
        return out
    finally:
        if own:
            fh.close()

# pointer byte layout
H_DIAG, H_E, H_F = 0, 1, 2
E_EXT_BIT = 4
F_EXT_BIT = 8


CKPT_ROWS = 128   # forward-carry checkpoint spacing (traceback block)


def _gotoh_row_fn(b, b_len, gap_open: int, gap_extend: int,
                  emit_ptr: bool):
    """Build the per-row scan body shared by the checkpointed forward
    pass (emit_ptr=False: only the column-b_len score is emitted) and
    the per-block pointer re-derivation (emit_ptr=True)."""
    B = b.shape[0]
    N = b.shape[1]
    sub = jnp.asarray(HOXD70)
    oe = gap_open + gap_extend
    ext = gap_extend
    j_idx = jnp.arange(N + 1, dtype=jnp.int32)
    b_scores = sub[:, b]                       # [4, B, N]
    ext_j = (ext * j_idx[1:]).astype(jnp.int32)  # [N]

    def row(carry, a_i):
        h_prev, f_prev = carry                 # [B, N+1]
        f_open = h_prev + oe
        f_ext = f_prev + ext
        f_row = jnp.maximum(f_open, f_ext)

        s = jnp.take_along_axis(
            b_scores, a_i[None, :, None].astype(jnp.int32), axis=0)[0]
        diag = h_prev[:, :-1] + s              # [B, N]

        g = jnp.maximum(diag, f_row[:, 1:])    # non-E candidates, j>=1
        # E via max-plus prefix over k < j:
        #   E[j] = ext*j + max_{k<j}( G'[k] + open - ext*k )
        # where G'[0] = H[i][0] (pure F boundary), G'[k>=1] = g[k]
        g0 = f_row[:, :1]                      # H[i][0] = F[i][0]
        gp = jnp.concatenate([g0, g[:, :-1]], axis=1)  # [B, N] (k=0..N-1)
        w = gp + gap_open - ext * j_idx[None, :-1]
        e_row = ext_j[None, :] + jax.lax.cummax(w, axis=1)   # [B, N]

        h_row_1 = jnp.maximum(g, e_row)
        h_row = jnp.concatenate([g0, h_row_1], axis=1)

        if not emit_ptr:
            h_at = jnp.take_along_axis(h_row, b_len[:, None], axis=1)[:, 0]
            return (h_row, f_row), h_at

        f_ext_bit = (f_row == f_ext) & (f_prev > NEG_INF // 2)
        e_ext_bit = jnp.concatenate([
            jnp.zeros((B, 1), bool),
            e_row[:, 1:] == e_row[:, :-1] + ext], axis=1)    # [B, N]
        h_src = jnp.where(
            h_row_1 == diag, H_DIAG,
            jnp.where(h_row_1 == e_row, H_E, H_F)).astype(jnp.uint8)
        ptr_j0 = jnp.full((B, 1), H_F, jnp.uint8) \
            | jnp.where(f_ext_bit[:, :1], F_EXT_BIT, 0).astype(jnp.uint8)
        ptr = (h_src
               | jnp.where(e_ext_bit, E_EXT_BIT, 0).astype(jnp.uint8)
               | jnp.where(f_ext_bit[:, 1:], F_EXT_BIT, 0).astype(jnp.uint8))
        ptr_row = jnp.concatenate([ptr_j0, ptr], axis=1)     # [B, N+1]
        return (h_row, f_row), ptr_row

    return row


def _gotoh_h0f0(B: int, N: int, gap_open: int, gap_extend: int):
    j_idx = jnp.arange(N + 1, dtype=jnp.int32)
    h0 = jnp.where(j_idx == 0, 0, gap_open + gap_extend * j_idx)
    h0 = jnp.broadcast_to(h0, (B, N + 1)).astype(jnp.int32)
    f0 = jnp.full((B, N + 1), NEG_INF, dtype=jnp.int32)
    return h0, f0


@functools.partial(jax.jit, static_argnums=(4, 5, 6))
def _gotoh_forward_ckpt(a, b, a_len, b_len, gap_open: int,
                        gap_extend: int, K: int):
    """Checkpointed forward DP.  a: uint8[B, M] with M a multiple of K.

    Returns (score int32[B], ck_h, ck_f float32[nb, B, N+1]) where
    ck_h/ck_f are the carries at the TOP of each K-row block."""
    B, M = a.shape
    N = b.shape[1]
    nb = M // K
    row = _gotoh_row_fn(b, b_len, gap_open, gap_extend, emit_ptr=False)
    h0, f0 = _gotoh_h0f0(B, N, gap_open, gap_extend)

    def block(carry, a_blk):
        ck = carry
        carry2, h_ats = jax.lax.scan(row, carry, a_blk)
        return carry2, (ck[0], ck[1], h_ats)

    a_blocks = a.T.reshape(nb, K, B)
    _, (ck_h, ck_f, h_at) = jax.lax.scan(block, (h0, f0), a_blocks)
    h_at = h_at.reshape(M, B)
    h0_at = jnp.take_along_axis(h0, b_len[:, None], axis=1)[:, 0]
    h_at = jnp.concatenate([h0_at[None], h_at], axis=0)      # rows 0..M
    score = jnp.take_along_axis(h_at, a_len[None, :], axis=0)[0]
    return score, ck_h, ck_f


@functools.partial(jax.jit, static_argnums=(5, 6))
def _gotoh_block_ptrs(ck_h, ck_f, a_blk, b, b_len, gap_open: int,
                      gap_extend: int):
    """Re-derive one block's packed pointer rows from its checkpoint.
    a_blk: uint8[B, K].  Returns uint8[B, K, N+1]."""
    row = _gotoh_row_fn(b, b_len, gap_open, gap_extend, emit_ptr=True)
    _, ptrs = jax.lax.scan(row, (ck_h, ck_f), a_blk.T)
    return jnp.transpose(ptrs, (1, 0, 2))


@jax.jit
def pack_ptrs(p):
    """Pack 4-bit pointer cells two per byte for the device->host fetch
    (pointer values use bits 0-3 only: state 0-2 + E/F extend bits)."""
    if p.shape[2] % 2:
        p = jnp.concatenate(
            [p, jnp.zeros(p.shape[:2] + (1,), jnp.uint8)], axis=2)
    return p[:, :, 0::2] | (p[:, :, 1::2] << 4)


def unpack_ptrs(packed: np.ndarray, width: int) -> np.ndarray:
    """Host inverse of pack_ptrs."""
    out = np.empty(packed.shape[:2] + (packed.shape[2] * 2,), np.uint8)
    out[:, :, 0::2] = packed & 0xF
    out[:, :, 1::2] = packed >> 4
    return out[:, :, :width]


# device-side traceback engages when the full pointer tensor fits this
# many bytes on device (B * M * (N+1)); above it, the host blockwise
# walk with per-block pointer fetches takes over.  Route-only (both
# walks give the same path); set on earlier hardware, re-tune on the GPU
DEVICE_TB_BUDGET = int(os.environ.get("LIBMEMS_TPU_DEVICE_TB_BUDGET",
                                      1 << 30))


@functools.partial(jax.jit, static_argnums=(3,))
def _device_tb_scan(ptrs, a_len, b_len, T: int):
    """On-device traceback walk over a full pointer tensor.

    The host traceback fetches packed pointers at DP-cells/2 bytes —
    the dominant transfer of the whole gapped stage (PERF rule 20).
    Walking on device instead fetches only T/8 x B bit rows: each scan
    step is one [B] gather + elementwise state updates, the exact state
    machine of traceback_blocks.  T = 2(M+N)+4 bounds the walk (every
    step consumes a row/column or enters E/F, which happens at most
    once per emitted column).  Returns bit-packed (steps, a_gaps,
    b_gaps) uint8[T/8, B]."""
    B, M, N1 = ptrs.shape
    flat = ptrs.reshape(B, M * N1)
    i0 = a_len.astype(jnp.int32)
    j0 = b_len.astype(jnp.int32)
    st0 = jnp.zeros_like(i0)

    def step(carry, _):
        i, j, st = carry
        active = (i > 0) | (j > 0)
        c0 = active & (i == 0)
        c1 = active & (i > 0) & (j == 0)
        c2 = active & (i > 0) & (j > 0)
        lin = jnp.clip((i - 1) * N1 + j, 0, M * N1 - 1)
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
    return pack(steps), pack(agaps), pack(bgaps)


def _device_tb_T(M: int, N: int) -> int:
    t = 2 * (M + N) + 4
    return -(-t // 8) * 8


def tb_unpack(packed, n_pairs: int, T: int):
    """Host tail of the device walk: unpack the bit rows and compact to
    per-pair (a_gaps, b_gaps) masks (traceback_blocks' contract)."""
    sp, ap, bp = packed
    steps = np.unpackbits(np.asarray(sp), axis=0, count=T).astype(bool)
    agaps = np.unpackbits(np.asarray(ap), axis=0, count=T).astype(bool)
    bgaps = np.unpackbits(np.asarray(bp), axis=0, count=T).astype(bool)
    out = []
    for k in range(n_pairs):
        sel = steps[:, k]
        out.append((agaps[sel, k][::-1].copy(),
                    bgaps[sel, k][::-1].copy()))
    return out


def device_traceback(ptrs, a_len: np.ndarray, b_len: np.ndarray,
                     T: int):
    """Run the on-device walk and compact to per-pair gap masks (same
    output contract as traceback_blocks)."""
    packed = _device_tb_scan(ptrs, jnp.asarray(a_len),
                             jnp.asarray(b_len), T)
    return tb_unpack(packed, len(a_len), T)


def traceback_blocks(fetch_block, nb: int, K: int, a_len: np.ndarray,
                     b_len: np.ndarray):
    """Batched affine traceback over checkpointed pointer blocks.

    fetch_block(bi) must return uint8[B, K, N+1] pointer rows for global
    rows bi*K+1 .. (bi+1)*K.  All pairs step in lockstep (vectorized
    numpy over the batch); per-pair gap masks come back as lists of
    (a_gaps, b_gaps) bool arrays, True = gap column.  Semantics are
    identical to the scalar per-cell traceback of the full-pointer
    formulation (state machine over H/E/F with extend bits)."""
    B = len(a_len)
    i = np.asarray(a_len, dtype=np.int64).copy()
    j = np.asarray(b_len, dtype=np.int64).copy()
    st = np.zeros(B, dtype=np.int64)
    rec_step: list[np.ndarray] = []
    rec_agap: list[np.ndarray] = []
    rec_bgap: list[np.ndarray] = []
    for bi in range(nb - 1, -1, -1):
        lo = bi * K
        boundary_ok = (i > 0) | (j > 0) if bi == 0 else np.zeros(B, bool)
        if not (np.any(i > lo) or np.any(boundary_ok)):
            continue
        P = fetch_block(bi)
        while True:
            if bi == 0:
                active = (i > 0) | (j > 0)
            else:
                active = i > lo
            if not active.any():
                break
            a_gap = np.zeros(B, bool)
            b_gap = np.zeros(B, bool)
            step = np.zeros(B, bool)
            c0 = active & (i == 0)                     # leading b columns
            a_gap |= c0
            j = np.where(c0, j - 1, j)
            c1 = active & (i > 0) & (j == 0)           # leading a columns
            b_gap |= c1
            i = np.where(c1, i - 1, i)
            c2 = active & (i > 0) & (j > 0)
            step |= c0 | c1
            if c2.any():
                idx = np.flatnonzero(c2)
                byte = np.zeros(B, np.int64)
                byte[idx] = P[idx, i[idx] - lo - 1, j[idx]]
                was_h = c2 & (st == 0)
                was_e = c2 & (st == 1)
                was_f = c2 & (st == 2)
                newst = byte & 3
                dm = was_h & (newst == 0)              # diagonal move
                step |= dm
                i = np.where(dm, i - 1, i)
                j = np.where(dm, j - 1, j)
                st = np.where(was_h, newst, st)        # enter E/F, no emit
                # E: gap in a, consume b column
                a_gap |= was_e
                step |= was_e
                j = np.where(was_e, j - 1, j)
                st = np.where(was_e,
                              np.where((byte & E_EXT_BIT) != 0, 1, 0), st)
                # F: gap in b, consume a row
                b_gap |= was_f
                step |= was_f
                i = np.where(was_f, i - 1, i)
                st = np.where(was_f,
                              np.where((byte & F_EXT_BIT) != 0, 2, 0), st)
            rec_step.append(step)
            rec_agap.append(a_gap)
            rec_bgap.append(b_gap)
    if rec_step:
        steps = np.stack(rec_step)       # [T, B]
        agaps = np.stack(rec_agap)
        bgaps = np.stack(rec_bgap)
    else:
        steps = np.zeros((0, B), bool)
        agaps = bgaps = steps
    out = []
    for k in range(B):
        sel = steps[:, k]
        out.append((agaps[sel, k][::-1].copy(),
                    bgaps[sel, k][::-1].copy()))
    return out


def _bucket(n: int, minimum: int = 32) -> int:
    b = minimum
    while b < n:
        b <<= 1
    return b


def align_pairs(pairs: list[tuple[np.ndarray, np.ndarray]],
                gap_open: int = GAP_OPEN, gap_extend: int = GAP_EXTEND
                ) -> list[tuple[np.ndarray, np.ndarray]]:
    """Globally align many (a_codes, b_codes) pairs on device.

    Returns per pair (a_gap_mask, b_gap_mask): boolean arrays over
    alignment columns, True where that row has a gap.  Pairs are bucketed
    by padded length to bound recompilation.
    """
    if not pairs:
        return []
    results: list = [None] * len(pairs)
    buckets: dict[tuple[int, int], list[int]] = {}
    for idx, (a, b) in enumerate(pairs):
        key = (_bucket(len(a)), _bucket(len(b)))
        buckets.setdefault(key, []).append(idx)

    for (M, N), idxs in buckets.items():
        Bpad = _bucket(len(idxs), 8)
        K = min(CKPT_ROWS, M)
        Mp = -(-M // K) * K
        a_arr = np.zeros((Bpad, Mp), dtype=np.uint8)
        b_arr = np.zeros((Bpad, N), dtype=np.uint8)
        a_len = np.zeros(Bpad, dtype=np.int32)
        b_len = np.zeros(Bpad, dtype=np.int32)
        for row, idx in enumerate(idxs):
            a, b = pairs[idx]
            a_arr[row, :len(a)] = a
            b_arr[row, :len(b)] = b
            a_len[row], b_len[row] = len(a), len(b)
        aj = jnp.asarray(a_arr)
        bj = jnp.asarray(b_arr)
        blj = jnp.asarray(b_len)
        if Bpad * Mp * (N + 1) <= DEVICE_TB_BUDGET:
            # full pointer tensor fits on device: derive it in one
            # forward and walk it there (fetch = gap-mask bits only)
            h0, f0 = _gotoh_h0f0(Bpad, N, gap_open, gap_extend)
            ptrs = _gotoh_block_ptrs(h0, f0, aj, bj, blj,
                                     gap_open, gap_extend)
            tb = device_traceback(ptrs, a_len, b_len,
                                  _device_tb_T(Mp, N))
        else:
            score, ck_h, ck_f = _gotoh_forward_ckpt(
                aj, bj, jnp.asarray(a_len), blj, gap_open, gap_extend, K)

            def fetch(bi, aj=aj, bj=bj, blj=blj, ck_h=ck_h, ck_f=ck_f,
                      K=K, N=N):
                return unpack_ptrs(np.asarray(pack_ptrs(
                    _gotoh_block_ptrs(
                        ck_h[bi], ck_f[bi], aj[:, bi * K:(bi + 1) * K],
                        bj, blj, gap_open, gap_extend))), N + 1)

            tb = traceback_blocks(fetch, Mp // K, K, a_len, b_len)
        for row, idx in enumerate(idxs):
            results[idx] = tb[row]
    return results


def align_score(a: np.ndarray, b: np.ndarray,
                gap_open: int = GAP_OPEN,
                gap_extend: int = GAP_EXTEND) -> int:
    """Score-only global alignment of one pair (for tests)."""
    M, N = _bucket(len(a)), _bucket(len(b))
    K = min(CKPT_ROWS, M)
    Mp = -(-M // K) * K
    a_arr = np.zeros((1, Mp), np.uint8)
    b_arr = np.zeros((1, N), np.uint8)
    a_arr[0, :len(a)] = a
    b_arr[0, :len(b)] = b
    score, _, _ = _gotoh_forward_ckpt(
        jnp.asarray(a_arr), jnp.asarray(b_arr),
        jnp.asarray(np.array([len(a)], np.int32)),
        jnp.asarray(np.array([len(b)], np.int32)), gap_open, gap_extend, K)
    return int(score[0])
