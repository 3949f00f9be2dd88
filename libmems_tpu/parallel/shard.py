"""Seed-prefix-range sharding of the mer table over a device mesh.

Device-mesh successor of the reference's two partitioning schemes:

* dmSML's out-of-core distribution sort — bin records by key prefix
  across scratch devices, sort bins independently (dmSML/dmsort.c);
* ParallelMemHash's chunked k-way merge with aligned chunk boundaries
  (libMems/ParallelMemHash.cpp:42-121).

Here the "scratch devices" are mesh devices and the "bins" are canonical
seed-content prefix ranges:

1. the concatenated (key, genome, position) window table is split evenly
   over the mesh ('shard' axis, data-parallel key extraction);
2. each device assigns every local row a bucket = the top
   log2(n_devices) bits of its canonical content;
3. `jax.lax.all_to_all` routes rows to their bucket owner (fixed
   per-pair capacity with sentinel padding — the static-shape analog of
   a ragged all-to-all);
4. each device sorts its received rows: equal-content runs are now
   device-local by construction, so MemHash-style seed enumeration
   (libmems_tpu.matchfind._mum_seed_flags) runs shard-locally and global
   counts are `psum`s.

Matches that straddle no boundary by construction is the key property:
the reference needed GetBreakpoint (MatchFinder.cpp:89-126) to re-align
chunk edges; prefix ownership makes the problem disappear.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from libmems_tpu import _jaxconfig  # noqa: F401
from libmems_tpu import seeds as seedlib
from libmems_tpu.ops import segments as seg

SHARD_AXIS = "shard"


def _vary(x):
    """Mark an array device-varying over the shard axis (loop-carry
    seeds built from constants inside shard_map need this)."""
    _pcast = getattr(jax.lax, "pcast", None)
    if _pcast is not None:
        return _pcast(x, (SHARD_AXIS,), to="varying")
    return jax.lax.pvary(x, (SHARD_AXIS,))


def _put(x, mesh: Mesh, spec) -> jax.Array:
    """Commit a host array to the mesh with an explicit sharding.

    In a MULTI-PROCESS run (jax.distributed) every process passes the
    same full host value and device_put installs only its addressable
    shards — the documented way to build process-spanning inputs.  In a
    single-process run this is an ordinary sharded put."""
    from jax.sharding import NamedSharding
    return jax.device_put(jnp.asarray(x), NamedSharding(mesh, spec))


def _np_global(x) -> np.ndarray:
    """Fetch a sharded array to host numpy, allgathering across
    processes when shards live on other hosts."""
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils
        x = multihost_utils.process_allgather(x, tiled=True)
    return np.asarray(x)


def make_mesh(n_devices: int | None = None, axis: str = SHARD_AXIS) -> Mesh:
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (axis,))


def _bucket_of(content: jax.Array, weight: int, n_devices: int) -> jax.Array:
    """Owner device of each row.

    Canonical content = min(fwd, revcomp) is biased low (the min of two
    near-uniform values), so raw top-bits bucketing loads shard 0 ~4x
    the average.  A Fibonacci multiplicative mix first decorrelates the
    bucket from the value while remaining a pure function of content, so
    equal-content runs still land on one owner shard.
    """
    bucket_bits = max((n_devices - 1).bit_length(), 1)
    mixed = content.astype(jnp.uint64) * jnp.uint64(0x9E3779B97F4A7C15)
    b = (mixed >> jnp.uint64(64 - bucket_bits)).astype(jnp.int32)
    return jnp.minimum(b, n_devices - 1)


def sharded_seed_table(keys: jax.Array, gid: jax.Array, pos: jax.Array,
                       mesh: Mesh, weight: int):
    """Route windows to their content-range owners and sort shard-locally.

    Args:
      keys/gid/pos: global window table, length padded to a multiple of
        the mesh size; padding rows must carry the all-ones sentinel key.
    Returns:
      (content, gid, pos, strand) with a leading device axis; rows with
      sentinel content are padding.
    """
    n_dev = mesh.devices.size
    sentinel = jnp.array(~jnp.zeros((), keys.dtype), keys.dtype)

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS)),
        out_specs=(P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS),
                   P(SHARD_AXIS)))
    def route(k, g, p):
        (rcontent, rg, rp, rstrand), _ = _route_local(
            k, g, p, weight, n_dev, sentinel, send_cap=k.shape[0])
        return (rcontent[None], rg[None], rp[None], rstrand[None])

    return route(keys, gid, pos)


def sharded_mum_seed_count(keys: jax.Array, gid: jax.Array, pos: jax.Array,
                           mesh: Mesh, weight: int,
                           repeat_tolerance: int = 0,
                           repeat_limit: int = 1000) -> jax.Array:
    """Count surviving unique-MUM seed runs across the mesh (scalar).

    The distributed analog of _mum_seed_flags' run census: runs live
    entirely on their owner shard, so the global count is a psum of
    local counts.  Sentinel (padding) rows form a trailing pseudo-run
    that never survives (single pseudo-genome-id, high repeat count).
    """
    content, g, p, strand = sharded_seed_table(keys, gid, pos, mesh, weight)
    sentinel_content = (~jnp.zeros((), content.dtype)) >> 1

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS)),
        out_specs=P())
    def census(c, g, p):
        c, g, p = c[0], g[0], p[0]
        sc = seg.run_starts(c)
        scg = seg.run_starts(c, g)
        subrun_len = seg.run_lengths(scg)
        max_subrun = seg.segment_max_broadcast(subrun_len, sc)
        ngids = seg.segment_sum_broadcast(scg.astype(jnp.int32), sc)
        runlen = seg.run_lengths(sc)
        keep_run = (ngids >= 2) & (max_subrun <= repeat_tolerance + 1) \
            & (runlen <= repeat_limit) & (c != sentinel_content)
        local = jnp.sum((sc & keep_run).astype(jnp.int32))
        return jax.lax.psum(local, SHARD_AXIS)

    return census(content, g, p)


def shard_loads(keys: jax.Array, gid: jax.Array, pos: jax.Array,
                mesh: Mesh, weight: int) -> np.ndarray:
    """Per-shard received row counts after prefix routing — the load-
    balance diagnostic for the Fibonacci-mixed bucket assignment
    (_bucket_of).  Returns int64[n_dev] non-sentinel rows per shard."""
    n_dev = mesh.devices.size
    sentinel = jnp.array(~jnp.zeros((), keys.dtype), keys.dtype)

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS)),
        out_specs=P(SHARD_AXIS))
    def route(k, g, p):
        (rcontent, _, _, _), _ = _route_local(
            k, g, p, weight, n_dev, sentinel, send_cap=k.shape[0])
        sentinel_content = sentinel >> 1
        return jnp.sum(rcontent != sentinel_content)[None]

    return np.asarray(route(keys, gid, pos)).astype(np.int64)


def _bucket_pad_rows(keys, gid, pos, keys_po):
    """Sentinel-pad the routed table AND the position-order key table to
    the shared sqrt(2)-spaced length bucket (PERF rule 27: every traced
    input must be bucket-padded or each genome family recompiles the
    shard step).  Sentinel rows route to the drop bucket in
    _route_local and extension never probes them (offs/cnts keep the
    unpadded layout)."""
    from libmems_tpu.sml import _bucket_len
    n = len(keys)
    b = _bucket_len(n)
    if b == n:
        return keys, gid, pos, keys_po
    sent = np.array(np.iinfo(keys.dtype).max, dtype=keys.dtype)
    keys = np.concatenate([keys, np.full(b - n, sent, keys.dtype)])
    gid = np.concatenate([gid, np.zeros(b - n, gid.dtype)])
    pos = np.concatenate([pos, np.zeros(b - n, pos.dtype)])
    keys_po = jnp.concatenate(
        [keys_po, jnp.full((b - n,), sent, keys_po.dtype)])
    return keys, gid, pos, keys_po


def _bucketed_total(smls, n_dev: int) -> int:
    """Shared static-size base for capacity/route_cap derivation: the
    bucket-padded window total rounded to the mesh size."""
    from libmems_tpu.sml import _bucket_len
    totb = _bucket_len(sum(s.n_windows for s in smls))
    return totb + ((-totb) % n_dev)


def _route_local(k, g, p, weight: int, n_dev: int, sentinel,
                 send_cap: int | None = None):
    """Shard-local body of the prefix routing: order rows by destination
    bucket, build the [n_dev, C] send buffers, all_to_all, then sort the
    received rows by (content, gid, pos).

    C defaults to 2x the balanced share T/n_dev (the mixed bucket
    assignment is near-uniform), NOT T — the send buffer is therefore
    O(local rows), not n_dev x local rows.  Rows beyond a destination's
    capacity are dropped and counted; callers psum the returned drop
    count and retry with a larger cap on overflow.

    Returns ((content, gid, pos, strand) local sorted arrays, dropped)."""
    T = k.shape[0]
    content = k >> 1
    bucket = _bucket_of(content, weight, n_dev)
    bucket = jnp.where(k == sentinel, n_dev, bucket)
    bucket, k_s, g_s, p_s = jax.lax.sort(
        (bucket, k, g, p), num_keys=1, is_stable=False)
    C = send_cap if send_cap is not None else max(
        256, 2 * (T + n_dev - 1) // n_dev)
    idx_in_bucket = jnp.arange(T, dtype=jnp.int32) - seg.start_index(
        seg.run_starts(bucket))
    send_k = jnp.full((n_dev, C), sentinel, dtype=k.dtype)
    send_g = jnp.zeros((n_dev, C), dtype=g.dtype)
    send_p = jnp.zeros((n_dev, C), dtype=p.dtype)
    over = (bucket < n_dev) & (idx_in_bucket >= C)
    dropped = jnp.sum(over.astype(jnp.int32))
    dst = jnp.where((bucket < n_dev) & ~over, bucket, n_dev)
    send_k = send_k.at[dst, idx_in_bucket].set(k_s, mode="drop")
    send_g = send_g.at[dst, idx_in_bucket].set(g_s, mode="drop")
    send_p = send_p.at[dst, idx_in_bucket].set(p_s, mode="drop")
    recv_k = jax.lax.all_to_all(send_k, SHARD_AXIS, 0, 0, tiled=False)
    recv_g = jax.lax.all_to_all(send_g, SHARD_AXIS, 0, 0, tiled=False)
    recv_p = jax.lax.all_to_all(send_p, SHARD_AXIS, 0, 0, tiled=False)
    rk = recv_k.reshape(-1)
    rg = recv_g.reshape(-1)
    rp = recv_p.reshape(-1)
    rcontent = rk >> 1
    rstrand = (rk & 1).astype(jnp.int32)
    return jax.lax.sort((rcontent, rg, rp, rstrand), num_keys=3,
                        is_stable=False), dropped


def sharded_find_mums(smls, mesh: Mesh, capacity: int | None = None,
                      chunk: int | None = None,
                      repeat_limit: int = 1000,
                      route_cap: int | None = None,
                      max_retries: int = 3,
                      repeat_tolerance: int = 0):
    """Full seed-prefix-sharded multi-MUM discovery (milestone M7).

    The distributed twin of matchfind._fused_mum_pipeline: windows are
    routed to their canonical-content owner shard (all_to_all over ICI
    with per-destination send capacity 2x the balanced share — O(rows),
    not n_dev x rows — and psum'd overflow detection), each shard
    enumerates its unique-MUM seed runs, extends its candidates in
    lockstep, and DEDUPS shard-locally before the host gather.
    Per-device live memory is proportional to total/n_dev throughout
    routing, enumeration, and candidate storage; the one replicated
    structure left is the position-order key table read by extension
    (G x L x 4B — MBs at bacterial scale; a position-tile halo exchange
    replaces it at multi-host genome counts, see SURVEY M7).
    Cross-shard duplicate candidates (seeds of one maximal match that
    hashed to different shards) collapse in the final host-side dedup.

    Routing-buffer or candidate-capacity overflow (psum'd counts) is
    retried automatically with the overflowing capacity doubled, up to
    max_retries times — skew beyond the 2x balanced share assumption
    (pathological key mixes) degrades to a recompile, never a wrong or
    failed result.

    Returns a MatchArray (same semantics as find_mums: unique MUMs,
    repeat_tolerance=0).
    """
    n_dev = mesh.devices.size
    total = _bucketed_total(smls, n_dev)
    if capacity is None:
        capacity = max(256, 1 << (total // n_dev - 1).bit_length())
    if route_cap is None:
        # per-destination send capacity: 2x the balanced share of one
        # device's local rows (local rows = total/n_dev, spread over
        # n_dev destinations)
        route_cap = max(256, 2 * (-(-total // n_dev) // n_dev))
    last = None
    for _ in range(max_retries + 1):
        ma, dropped, cand_over = _sharded_find_mums_once(
            smls, mesh, capacity, chunk, repeat_limit, route_cap,
            repeat_tolerance)
        if dropped == 0 and cand_over == 0:
            return ma
        if dropped:
            route_cap *= 2
        if cand_over:
            capacity *= 2
        last = (dropped, cand_over)
    raise ValueError(
        f"sharded_find_mums still overflowing after {max_retries} "
        f"retries (dropped={last[0]}, cand_over={last[1]}, "
        f"capacity={capacity}, route_cap={route_cap})")


def _sharded_find_mums_once(smls, mesh: Mesh, capacity: int,
                            chunk: int | None, repeat_limit: int,
                            route_cap: int, repeat_tolerance: int = 0):
    from libmems_tpu.match import MatchArray
    from libmems_tpu.ops.extend import extend_matches

    n_dev = mesh.devices.size
    G = len(smls)
    seed_len = smls[0].seed_length
    weight = smls[0].seed_weight
    if chunk is None:
        chunk = max(seed_len, 128)

    keys_po = jnp.concatenate([s.keys for s in smls])
    cnts_np = np.array([s.n_windows for s in smls], np.int32)
    offs_np = np.concatenate([[0], np.cumsum(cnts_np)[:-1]]).astype(np.int32)
    keys = np.concatenate([np.asarray(s.keys) for s in smls])
    gid = np.concatenate([np.full(c, i, np.int32)
                          for i, c in enumerate(cnts_np)])
    pos = np.concatenate([np.arange(c, dtype=np.int32) for c in cnts_np])
    keys, gid, pos, keys_po = _bucket_pad_rows(keys, gid, pos, keys_po)
    keys, gid, pos = pad_table_for_mesh(keys, gid, pos, n_dev)
    sentinel_val = np.array(np.iinfo(keys.dtype).max, dtype=keys.dtype)

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS),
                  P(), P(), P()),
        out_specs=(P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS), P(), P()))
    def step(k, g, p, keys_posorder, offs, cnts):
        sentinel = jnp.array(sentinel_val, k.dtype)
        (content, rg, rp, rstrand), dropped = _route_local(
            k, g, p, weight, n_dev, sentinel, send_cap=route_cap)
        sentinel_content = sentinel >> 1
        # MemHash seed enumeration on the local run table — runs are
        # shard-local by construction (routing keys on content), so the
        # same tolerance mask as _mum_seed_flags applies unchanged
        # (m_repeat_tolerance, MemHash.cpp:139-162; fanned out through
        # one interface like ParallelMemHash.cpp:42-121)
        sc = seg.run_starts(content)
        scg = seg.run_starts(content, rg)
        subrun_len = seg.run_lengths(scg)
        max_subrun = seg.segment_max_broadcast(subrun_len, sc)
        ngids = seg.segment_sum_broadcast(scg.astype(jnp.int32), sc)
        runlen = seg.run_lengths(sc)
        keep_run = (ngids >= 2) & (max_subrun <= repeat_tolerance + 1) \
            & (runlen <= repeat_limit) & (content != sentinel_content)
        kept_occ = scg & keep_run
        rid_at_start = jnp.cumsum((sc & keep_run).astype(jnp.int32)) - 1
        row_id = rid_at_start[seg.start_index(sc)]
        ref_strand = rstrand[seg.start_index(sc)]
        n_rows = jnp.where(keep_run.any(), rid_at_start[-1] + 1, 0)

        rid = jnp.where(kept_occ, jnp.minimum(row_id, capacity), capacity)
        starts = jnp.zeros((capacity + 1, G), dtype=jnp.int32)
        sign = jnp.where(rstrand == ref_strand, 1, -1).astype(jnp.int32)
        starts = starts.at[rid, rg].set(sign * (rp + 1), mode="drop")
        starts = starts[:capacity]
        valid = jnp.arange(capacity) < jnp.minimum(n_rows, capacity)

        present = (starts != 0) & valid[:, None]
        lefts = jnp.where(present, jnp.abs(starts) - 1, 0)
        is_fwd = starts > 0
        lengths = jnp.full((capacity,), seed_len, dtype=jnp.int32)
        _pcast = getattr(jax.lax, "pcast", None)
        if _pcast is not None:
            lengths = _pcast(lengths, (SHARD_AXIS,), to="varying")
        else:
            lengths = jax.lax.pvary(lengths, (SHARD_AXIS,))
        lefts, lengths = extend_matches(
            keys_posorder, seed_len, chunk,
            jnp.broadcast_to(offs, (capacity, G)),
            jnp.broadcast_to(cnts, (capacity, G)),
            lefts, present, is_fwd, lengths)
        out_starts = jnp.where(present, jnp.sign(starts) * (lefts + 1), 0)
        # shard-local dedup before the host gather: identical extended
        # rows collapse here so the gather moves ~unique matches only
        sort_ops = tuple(out_starts[:, gg] for gg in range(G)) + (
            lengths, (~valid).astype(jnp.int32))
        sorted_ops = jax.lax.sort(sort_ops, num_keys=G + 2,
                                  is_stable=False)
        srows = jnp.stack(sorted_ops[:G + 1], axis=1)
        svalid = sorted_ops[G + 1] == 0
        first = jnp.concatenate([
            jnp.ones((1,), bool),
            jnp.any(srows[1:] != srows[:-1], axis=1)])
        uniq = svalid & first
        dropped_sum = jax.lax.psum(dropped, SHARD_AXIS)
        cand_over = jax.lax.psum(
            jnp.maximum(n_rows - capacity, 0), SHARD_AXIS)
        return (srows[None, :, :G], srows[None, :, G], uniq[None],
                dropped_sum, cand_over)

    starts, lengths, valid, dropped, cand_over = step(
        _put(keys, mesh, P(SHARD_AXIS)), _put(gid, mesh, P(SHARD_AXIS)),
        _put(pos, mesh, P(SHARD_AXIS)), _put(keys_po, mesh, P()),
        _put(offs_np, mesh, P()), _put(cnts_np, mesh, P()))
    dropped, cand_over = int(dropped), int(cand_over)
    if dropped or cand_over:
        return None, dropped, cand_over
    starts = _np_global(starts).reshape(-1, G)
    lengths = _np_global(lengths).reshape(-1)
    valid = _np_global(valid).reshape(-1)
    ma = MatchArray(starts[valid].astype(np.int64),
                    lengths[valid].astype(np.int64))
    return ma.dedup().canonical_sort(), 0, 0


def sharded_find_pairwise_mums(smls, mesh: Mesh, capacity: int | None = None,
                               chunk: int | None = None,
                               repeat_limit: int = 1000,
                               route_cap: int | None = None,
                               max_retries: int = 3):
    """Seed-prefix-sharded PairwiseMatchFinder (the progressiveMauve
    seeder, libMems/PairwiseMatchFinder.cpp:37-71, parallelized the way
    ParallelMemHash parallelized MemHash — same interface, fanned out).

    Routing is identical to sharded_find_mums; enumeration differs:
    occurrences unique within their genome pair up across genomes
    ((G-1) shifted compares), runs being shard-local by construction.
    Pair clustering, span-seeded extension, and shard-local dedup reuse
    matchfind._pairwise_core verbatim.  Overflow (routing buffer or
    representative capacity, psum'd) retries with doubled capacity.

    Returns a MatchArray with find_pairwise_mums semantics.
    """
    n_dev = mesh.devices.size
    G = len(smls)
    if G > 62:
        raise ValueError("sharded pairwise seeder supports <= 62 genomes")
    total = _bucketed_total(smls, n_dev)
    if capacity is None:
        capacity = max(256, 1 << (total // n_dev - 1).bit_length())
    if route_cap is None:
        route_cap = max(256, 2 * (-(-total // n_dev) // n_dev))
    last = None
    for _ in range(max_retries + 1):
        ma, dropped, cand_over = _sharded_pairwise_once(
            smls, mesh, capacity, chunk, repeat_limit, route_cap)
        if dropped == 0 and cand_over == 0:
            return ma
        if dropped:
            route_cap *= 2
        if cand_over:
            capacity *= 2
        last = (dropped, cand_over)
    raise ValueError(
        f"sharded_find_pairwise_mums still overflowing after "
        f"{max_retries} retries (dropped={last[0]}, cand_over={last[1]}, "
        f"capacity={capacity}, route_cap={route_cap})")


def _sharded_pairwise_once(smls, mesh: Mesh, capacity: int,
                           chunk: int | None, repeat_limit: int,
                           route_cap: int):
    from libmems_tpu.match import MatchArray
    from libmems_tpu.matchfind import (_pairwise_core, _unique_occ_flags,
                                       pairwise_fused_fits)

    n_dev = mesh.devices.size
    G = len(smls)
    seed_len = smls[0].seed_length
    weight = smls[0].seed_weight
    if chunk is None:
        chunk = max(seed_len, 256)

    cnts_np = np.array([s.n_windows for s in smls], np.int32)
    offs_np = np.concatenate([[0], np.cumsum(cnts_np)[:-1]]).astype(np.int32)
    keys_po = jnp.concatenate([s.keys for s in smls])
    keys = np.concatenate([np.asarray(s.keys) for s in smls])
    gid = np.concatenate([np.full(c, i, np.int32)
                          for i, c in enumerate(cnts_np)])
    pos = np.concatenate([np.arange(c, dtype=np.int32) for c in cnts_np])
    keys, gid, pos, keys_po = _bucket_pad_rows(keys, gid, pos, keys_po)
    keys, gid, pos = pad_table_for_mesh(keys, gid, pos, n_dev)
    sentinel_val = np.array(np.iinfo(keys.dtype).max, dtype=keys.dtype)

    # packed-word budget for the local pair tables (worst case: every
    # routed row lands on one shard)
    pos_bits = max(int(cnts_np.max(initial=1)).bit_length(), 8)
    rid_bits = (len(keys) + 1).bit_length()
    if not pairwise_fused_fits(G, pos_bits, rid_bits):
        raise ValueError(
            f"packed pair words exceed 64 bits (G={G}, pos_bits="
            f"{pos_bits}, rid_bits={rid_bits}); genomes too large for "
            "the sharded pairwise seeder's packed layout")

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS),
                  P(), P(), P()),
        out_specs=(P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS), P(), P()))
    def step(k, g, p, keys_posorder, offs, cnts):
        sentinel = jnp.array(sentinel_val, k.dtype)
        (content, rg, rp, rstrand), dropped = _route_local(
            k, g, p, weight, n_dev, sentinel, send_cap=route_cap)
        unique_occ, run_id = _unique_occ_flags(
            content, rg, rp, rstrand.astype(jnp.uint8), repeat_limit)
        srows, lengths, uniq, _, n_reps = _pairwise_core(
            seed_len, chunk, G, pos_bits, rid_bits, capacity,
            keys_posorder, content, rg, rp,
            rstrand.astype(jnp.uint8), unique_occ, run_id, offs, cnts,
            vary=_vary)
        dropped_sum = jax.lax.psum(dropped, SHARD_AXIS)
        cand_over = jax.lax.psum(
            jnp.maximum(n_reps - capacity, 0), SHARD_AXIS)
        return (srows[None], lengths[None], uniq[None],
                dropped_sum, cand_over)

    srows, lengths, uniq, dropped, cand_over = step(
        _put(keys, mesh, P(SHARD_AXIS)), _put(gid, mesh, P(SHARD_AXIS)),
        _put(pos, mesh, P(SHARD_AXIS)), _put(keys_po, mesh, P()),
        _put(offs_np, mesh, P()), _put(cnts_np, mesh, P()))
    dropped, cand_over = int(dropped), int(cand_over)
    if dropped or cand_over:
        return None, dropped, cand_over
    starts = _np_global(srows).reshape(-1, G)
    lengths = _np_global(lengths).reshape(-1)
    valid = _np_global(uniq).reshape(-1)
    ma = MatchArray(starts[valid].astype(np.int64),
                    lengths[valid].astype(np.int64))
    return ma.dedup().canonical_sort(), 0, 0


# ---------------------------------------------------------------------------
# tiled-extension sharded pipeline: O(total/n_dev) per-device memory
# ---------------------------------------------------------------------------

def _dist_fetch_factory(tile_halo, tile_size: int, n_dev: int,
                        req_cap: int):
    """Span fetch for ops.extend.extend_core served by position-tile
    owners (SURVEY M7 halo exchange, generalized): the padded global key
    table is tiled over the mesh; each probe round routes (row, start)
    requests to the owner of `start // tile_size` with one all_to_all,
    owners slice [start, start+C) from their tile+halo, and a second
    all_to_all returns the spans.  The halo (max probe window plus a
    128-key margin) makes every span whose START lies in a tile fully
    local to its owner.  Per-destination request capacity is fixed; overflow
    is counted into dropped_box for a host-side retry (a dropped
    request yields sentinel keys = a conservatively short match, never
    a wrong one — the retry restores exactness)."""
    from libmems_tpu.ops.extend import _fetch_spans

    my = jax.lax.axis_index(SHARD_AXIS).astype(jnp.int32)
    base = my * tile_size
    sentinel_row = ~jnp.zeros((), tile_halo.dtype)

    def fetch(span_start, C, aux):
        R = span_start.shape[0]
        rows = jnp.arange(R, dtype=jnp.int32)
        dest = jnp.clip(span_start // tile_size, 0, n_dev - 1) \
            .astype(jnp.int32)
        d_s, start_s, row_s = jax.lax.sort(
            (dest, span_start, rows), num_keys=2, is_stable=False)
        sc = seg.run_starts(d_s)
        idx_in = rows - seg.start_index(sc)
        over = idx_in >= req_cap
        aux = aux + jnp.sum(over.astype(jnp.int32))
        slot = jnp.where(over, req_cap, idx_in)
        send = jnp.full((n_dev, req_cap + 1), -1, jnp.int32) \
            .at[d_s, slot].set(start_s, mode="drop")[:, :req_cap]
        req = jax.lax.all_to_all(send, SHARD_AXIS, 0, 0, tiled=False)
        local = req.reshape(-1) - base
        junk = (local < 0) | (local >= tile_size)
        served = _fetch_spans(tile_halo,
                              jnp.where(junk, 0, local).astype(jnp.int32),
                              C)
        served = jnp.where(junk[:, None], sentinel_row, served)
        served = served.reshape(n_dev, req_cap, C)
        resp = jax.lax.all_to_all(served, SHARD_AXIS, 0, 0, tiled=False)
        flat = resp.reshape(n_dev * req_cap, C)
        safe_slot = jnp.minimum(d_s * req_cap + idx_in,
                                n_dev * req_cap - 1)
        spans_sorted = jnp.where(over[:, None], sentinel_row,
                                 flat[safe_slot])
        _, inv = jax.lax.sort((row_s, rows), num_keys=1, is_stable=False)
        return spans_sorted[inv], aux

    return fetch


def build_position_tiles(keys_concat: np.ndarray, n_dev: int,
                         max_chunk: int):
    """Host-side construction of the padded, tiled key table.

    The padded global space is [sentinel*max_chunk | keys | sentinel
    tail] rounded so tile_size is a multiple of 128; device d's slice is
    padded[d*S : (d+1)*S + halo] (halo = max_chunk + 128 so any span
    starting inside a tile is owner-local).  Returns (tiles [n_dev,
    S+halo], tile_size S, big_offset)."""
    big = max_chunk
    Ntot = len(keys_concat)
    halo = max_chunk + 128
    S = -(-(big + Ntot + halo) // n_dev)
    S += (-S) % 128
    total = n_dev * S + halo
    sentinel = np.array(~keys_concat.dtype.type(0), keys_concat.dtype)
    padded = np.full(total, sentinel, keys_concat.dtype)
    padded[big:big + Ntot] = keys_concat
    tiles = np.stack([padded[d * S: d * S + S + halo]
                      for d in range(n_dev)])
    return tiles, S, big


def sharded_find_mums_tiled(smls, mesh: Mesh, capacity: int | None = None,
                            chunk: int | None = None,
                            repeat_limit: int = 1000,
                            route_cap: int | None = None,
                            req_cap: int | None = None,
                            max_retries: int = 4):
    """sharded_find_mums with the position-tiled extension: NO device
    holds the full key table — enumeration reads content-routed rows,
    extension reads position-tile spans via the request/response
    all_to_all (_dist_fetch_factory).  Per-device memory is
    O(total/n_dev) end to end (SURVEY M7).

    The probe rounds are driven from the HOST (r4): each round is one
    jitted shard_map step whose collectives sit in straight-line code,
    and the candidate state (sharded arrays) stays on device between
    rounds.  The previous structure — the all_to_all request/response
    inside a compiled while-loop — did not compile in reasonable time
    on earlier hardware; host-stepping bounds the compiled program at
    ONE round and costs one scalar fetch per round to decide
    termination."""
    n_dev = mesh.devices.size
    total0 = sum(s.n_windows for s in smls)
    total = total0 + ((-total0) % n_dev)
    if capacity is None:
        capacity = max(256, 1 << (total // n_dev - 1).bit_length())
    if route_cap is None:
        route_cap = max(256, 2 * (-(-total // n_dev) // n_dev))
    if req_cap is None:
        req_cap = max(128, 4 * (-(-capacity // n_dev)))
    last = None
    for _ in range(max_retries + 1):
        ma, dropped, cand_over, fetch_drop = _sharded_tiled_once(
            smls, mesh, capacity, chunk, repeat_limit, route_cap,
            req_cap)
        if dropped == 0 and cand_over == 0 and fetch_drop == 0:
            return ma
        if dropped:
            route_cap *= 2
        if cand_over:
            capacity *= 2
        if fetch_drop:
            req_cap *= 2
        last = (dropped, cand_over, fetch_drop)
    raise ValueError(
        f"sharded_find_mums_tiled still overflowing after {max_retries} "
        f"retries {last}; capacity={capacity}, route_cap={route_cap}, "
        f"req_cap={req_cap}")


def _sharded_tiled_once(smls, mesh: Mesh, capacity: int,
                        chunk: int | None, repeat_limit: int,
                        route_cap: int, req_cap: int):
    from libmems_tpu.match import MatchArray
    from libmems_tpu.ops.extend import make_probe_round

    n_dev = mesh.devices.size
    G = len(smls)
    seed_len = smls[0].seed_length
    weight = smls[0].seed_weight
    if chunk is None:
        # wider than the local default: every probe round is a host
        # round-trip here, so fewer/wider rounds win
        chunk = max(seed_len, 512)
    # single probe width (no escalation): long matches take more uniform
    # host-stepped rounds instead of wider probes, keeping the one
    # compiled round small
    max_chunk = chunk

    cnts_np = np.array([s.n_windows for s in smls], np.int32)
    offs_np = np.concatenate([[0], np.cumsum(cnts_np)[:-1]]).astype(np.int32)
    keys_np = np.concatenate([np.asarray(s.keys) for s in smls])
    tiles_np, tile_size, big = build_position_tiles(keys_np, n_dev,
                                                    max_chunk)
    gid = np.concatenate([np.full(c, i, np.int32)
                          for i, c in enumerate(cnts_np)])
    pos = np.concatenate([np.arange(c, dtype=np.int32) for c in cnts_np])
    keys, gid, pos = pad_table_for_mesh(keys_np, gid, pos, n_dev)
    sentinel_val = np.array(np.iinfo(keys.dtype).max, dtype=keys.dtype)

    # --- step 1: route + enumerate + candidate init (one jit, no loops)
    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS)),
        out_specs=(P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS), P(), P()))
    def init_step(k, g, p):
        sentinel = jnp.array(sentinel_val, k.dtype)
        (content, rg, rp, rstrand), dropped = _route_local(
            k, g, p, weight, n_dev, sentinel, send_cap=route_cap)
        sentinel_content = sentinel >> 1
        sc = seg.run_starts(content)
        scg = seg.run_starts(content, rg)
        subrun_len = seg.run_lengths(scg)
        max_subrun = seg.segment_max_broadcast(subrun_len, sc)
        ngids = seg.segment_sum_broadcast(scg.astype(jnp.int32), sc)
        runlen = seg.run_lengths(sc)
        keep_run = (ngids >= 2) & (max_subrun <= 1) \
            & (runlen <= repeat_limit) & (content != sentinel_content)
        kept_occ = scg & keep_run
        rid_at_start = jnp.cumsum((sc & keep_run).astype(jnp.int32)) - 1
        row_id = rid_at_start[seg.start_index(sc)]
        ref_strand = rstrand[seg.start_index(sc)]
        n_rows = jnp.where(keep_run.any(), rid_at_start[-1] + 1, 0)

        rid = jnp.where(kept_occ, jnp.minimum(row_id, capacity), capacity)
        starts = jnp.zeros((capacity + 1, G), dtype=jnp.int32)
        sign = jnp.where(rstrand == ref_strand, 1, -1).astype(jnp.int32)
        starts = starts.at[rid, rg].set(sign * (rp + 1), mode="drop")
        starts = starts[:capacity]
        valid = jnp.arange(capacity) < jnp.minimum(n_rows, capacity)
        starts = jnp.where(valid[:, None], starts, 0)

        dropped_sum = jax.lax.psum(dropped, SHARD_AXIS)
        cand_over = jax.lax.psum(
            jnp.maximum(n_rows - capacity, 0), SHARD_AXIS)
        return starts[None], valid[None], _vary(
            jnp.full((1, capacity), seed_len, jnp.int32)), \
            dropped_sum, cand_over

    # --- step 2: ONE probe round per call, host-driven termination
    def make_probe_step(side: int):
        @functools.partial(
            jax.shard_map, mesh=mesh,
            in_specs=(P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS),
                      P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS),
                      P(), P()),
            out_specs=(P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS),
                       P(SHARD_AXIS), P()))
        def step(tile, starts, lefts, lengths, active, aux, offs, cnts):
            tile, starts = tile[0], starts[0]
            lefts, lengths = lefts[0], lengths[0]
            active, aux = active[0], aux[0]
            present = starts != 0
            is_fwd = starts > 0
            fetch = _dist_fetch_factory(tile, tile_size, n_dev, req_cap)
            pr = make_probe_round(
                fetch, tile.dtype, seed_len, max_chunk,
                jnp.broadcast_to(offs, (capacity, G)),
                jnp.broadcast_to(cnts, (capacity, G)), present, is_fwd)
            lefts, lengths, active, aux = pr(side, chunk, lefts, lengths,
                                             active, aux)
            n_active = jax.lax.psum(jnp.any(active).astype(jnp.int32),
                                    SHARD_AXIS)
            return (lefts[None], lengths[None], active[None], aux[None],
                    n_active)

        return jax.jit(step)

    # --- step 3: shard-local dedup + output rows
    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS),
                  P(SHARD_AXIS)),
        out_specs=(P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS)))
    def finalize_step(starts, valid, lefts, lengths):
        starts, valid = starts[0], valid[0]
        lefts, lengths = lefts[0], lengths[0]
        present = starts != 0
        out_starts = jnp.where(present, jnp.sign(starts) * (lefts + 1), 0)
        sort_ops = tuple(out_starts[:, gg] for gg in range(G)) + (
            lengths, (~valid).astype(jnp.int32))
        sorted_ops = jax.lax.sort(sort_ops, num_keys=G + 2,
                                  is_stable=False)
        srows = jnp.stack(sorted_ops[:G + 1], axis=1)
        svalid = sorted_ops[G + 1] == 0
        first = jnp.concatenate([
            jnp.ones((1,), bool),
            jnp.any(srows[1:] != srows[:-1], axis=1)])
        uniq = svalid & first
        return srows[None, :, :G], srows[None, :, G], uniq[None]

    starts, valid, lengths, dropped, cand_over = init_step(
        _put(keys, mesh, P(SHARD_AXIS)), _put(gid, mesh, P(SHARD_AXIS)),
        _put(pos, mesh, P(SHARD_AXIS)))
    dropped, cand_over = int(dropped), int(cand_over)
    if dropped or cand_over:
        return None, dropped, cand_over, 0

    tiles = _put(tiles_np, mesh, P(SHARD_AXIS))
    present_any = jnp.any(starts != 0, axis=-1)
    lefts = jnp.where(starts != 0, jnp.abs(starts) - 1, 0)
    aux = jnp.zeros((n_dev,), jnp.int32)
    offs_j = _put(offs_np, mesh, P())
    cnts_j = _put(cnts_np, mesh, P())
    import os as _os
    _dbg = _os.environ.get("LIBMEMS_TPU_DEBUG_TILED")
    for side in (0, 1):
        probe = make_probe_step(side)
        active = present_any
        rounds = 0
        while True:
            import time as _t
            _t0 = _t.time()
            lefts, lengths, active, aux, n_active = probe(
                tiles, starts, lefts, lengths, active, aux,
                offs_j, cnts_j)
            n_active = int(n_active)
            rounds += 1
            if _dbg:
                print(f"tiled side={side} round={rounds} "
                      f"n_active={n_active} dt={_t.time()-_t0:.2f}",
                      flush=True)
            if n_active == 0:
                break

    fetch_drop = int(_np_global(aux).sum())
    if fetch_drop:
        return None, 0, 0, fetch_drop
    srows, slens, uniq = finalize_step(starts, valid, lefts, lengths)
    out_starts = _np_global(srows).reshape(-1, G)
    out_lens = _np_global(slens).reshape(-1)
    out_valid = _np_global(uniq).reshape(-1)
    ma = MatchArray(out_starts[out_valid].astype(np.int64),
                    out_lens[out_valid].astype(np.int64))
    return ma.dedup().canonical_sort(), 0, 0, 0


def pad_table_for_mesh(keys: np.ndarray, gid: np.ndarray, pos: np.ndarray,
                       n_devices: int):
    """Pad the global window table to a multiple of the mesh size with
    sentinel rows (all-ones key)."""
    n = len(keys)
    pad = (-n) % n_devices
    if pad:
        sentinel = np.array(np.iinfo(keys.dtype).max, dtype=keys.dtype)
        keys = np.concatenate([keys, np.full(pad, sentinel, keys.dtype)])
        gid = np.concatenate([gid, np.zeros(pad, gid.dtype)])
        pos = np.concatenate([pos, np.zeros(pad, pos.dtype)])
    return keys, gid, pos
