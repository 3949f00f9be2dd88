"""Multi-host (multi-process) entry for the sharded alignment pipeline.

The reference's whole scaling story was out-of-core key-range
partitioning on one machine (dmSML/dmsort.c bins the mer stream by key
prefix across scratch disks; FileSML::BigCreate/Merge split-sort-merge,
libMems/FileSML.cpp:417-660).  The multi-host design here promotes
the same idea across processes:

* **host-sharded SML construction** — each process builds the sorted
  mer index only for the genomes it owns (`owned_genomes`; the
  expensive per-genome sort never leaves the owner host);
* **one global device mesh** spanning every process's chips
  (`global_mesh`); the seed-prefix routing, shard-local enumeration,
  and extension of `parallel.shard` run unchanged over it — cross-host
  row routing rides the same `all_to_all`, now crossing DCN where the
  mesh crosses hosts;
* the per-device replicated position-order key table is assembled by a
  one-time metadata + key-table exchange (`gather_key_tables`).  That
  replication is the documented residency limit of the non-tiled path
  (PERF.md rule 16); the position-tiled variant removes it at the cost
  of host-stepped probe rounds.

Validation scope (stated honestly): real 2-host hardware is not
available in this environment.  The multi-process path is validated for
PROCESS TRANSPARENCY on a CPU dryrun — 2 processes x 4 virtual devices,
`python -m libmems_tpu.parallel.multihost_dryrun` — which checks that
every process runs the same program over the 8-device global mesh and
produces the single-process result bit-for-bit.  DCN/ICI throughput
claims are projections, not measurements (README "validated vs
projected").
"""

from __future__ import annotations

import numpy as np

from libmems_tpu import seeds as seedlib


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Bring up the JAX distributed runtime (jax.distributed.initialize
    wrapper).  Call once per process before any other JAX API; a
    single-process run may skip it entirely.  Pass the coordinator
    address, process count and process id explicitly: nothing on a
    plain GPU or CPU host tells JAX of the cluster."""
    import jax
    if num_processes is not None and num_processes <= 1:
        return
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def global_mesh(axis: str = "shard"):
    """Mesh over ALL processes' devices (DCN-spanning when multi-host)."""
    import jax
    from jax.sharding import Mesh
    return Mesh(np.array(jax.devices()), (axis,))


def owned_genomes(n_genomes: int) -> list[int]:
    """Genome ids this process owns (round-robin by process id) — the
    host-sharded analog of dmSML's per-scratch-device bin ownership."""
    import jax
    pid, nproc = jax.process_index(), jax.process_count()
    return [g for g in range(n_genomes) if g % nproc == pid]


class KeyTable:
    """Lightweight stand-in for SortedMerList carrying exactly what the
    sharded finders read: the position-order canonical key array plus
    seed metadata.  (The sorted arrays of a full SML are not needed —
    the sharded pipeline re-sorts routed rows shard-locally.)"""

    def __init__(self, seed: int, keys: np.ndarray):
        self.seed = seed
        self.keys = keys

    @property
    def n_windows(self) -> int:
        return int(self.keys.shape[0])

    @property
    def seed_length(self) -> int:
        return seedlib.seed_length(self.seed)

    @property
    def seed_weight(self) -> int:
        return seedlib.seed_weight(self.seed)


def build_owned_smls(genomes: dict[int, "object"] | list, seed: int):
    """Build SMLs for this process's owned genomes only.

    `genomes` maps genome id -> Genome/codes (a list is treated as all
    genomes, of which only the owned subset is built).  Returns
    {genome_id: SortedMerList}."""
    from libmems_tpu.sml import SortedMerList
    if isinstance(genomes, dict):
        items = genomes.items()
    else:
        own = set(owned_genomes(len(genomes)))
        items = [(g, genomes[g]) for g in own]
    return {g: SortedMerList.create(v, seed) for g, v in items}


def gather_key_tables(owned_smls: dict[int, "object"], n_genomes: int,
                      seed: int) -> list[KeyTable]:
    """Exchange per-genome key tables so every process holds the full
    list (the one-time replication the non-tiled extension requires;
    O(total windows) DCN bytes, paid once per run).

    Works by summing zero-padded per-owner buffers across processes
    (process_allgather): each genome's row is non-zero only on its
    owner, so the sum reconstructs it everywhere.  Single-process calls
    degenerate to a reshuffle with no communication."""
    import jax
    lengths = np.zeros(n_genomes, dtype=np.int64)
    for g, s in owned_smls.items():
        lengths[g] = s.n_windows
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils
        lengths = np.asarray(
            multihost_utils.process_allgather(lengths)).sum(axis=0)
    max_w = int(lengths.max())
    # key values use the full uint width (all-ones = sentinel), so an
    # owner-indicator plane rides along instead of a magic fill value
    key_dt = next(iter(owned_smls.values())).keys.dtype if owned_smls \
        else np.uint64
    buf = np.zeros((n_genomes, max_w), dtype=np.uint64)
    for g, s in owned_smls.items():
        buf[g, : s.n_windows] = np.asarray(s.keys).astype(np.uint64)
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils
        buf = np.asarray(
            multihost_utils.process_allgather(buf)).sum(axis=0)
    return [KeyTable(seed, buf[g, : lengths[g]].astype(key_dt))
            for g in range(n_genomes)]


def assert_processes_agree(tag: str, data: bytes) -> None:
    """Cross-process divergence tripwire for the redundant-deterministic
    host stages of the multi-host e2e contract: allgather a sha256 of
    `data` and fail loudly if any process computed something different
    (a silent divergence would corrupt every later collective)."""
    import jax
    if jax.process_count() <= 1:
        return
    import hashlib

    from jax.experimental import multihost_utils
    h = np.frombuffer(hashlib.sha256(data).digest(),
                      np.uint8).astype(np.int32)
    all_h = np.asarray(multihost_utils.process_allgather(h))
    if not (all_h == all_h[0]).all():
        raise RuntimeError(
            f"multi-host divergence at {tag!r}: processes computed "
            f"different results ({[bytes(r.astype(np.uint8)).hex()[:16] for r in all_h]})")


def _xmfa_bytes(ivs) -> bytes:
    import io

    from libmems_tpu.interval import write_xmfa
    buf = io.StringIO()
    write_xmfa(buf, ivs)
    return buf.getvalue().encode()


def multihost_align(genomes, config=None):
    """END-TO-END flat alignment under jax.process_count() >= 1
    (BASELINE config 5's driver; Aligner.cpp:2193 promoted across
    processes).  Contract: the host-sharded index build + seed-prefix-
    sharded seeding span the global mesh; every later stage (overlap
    trim, LCB/GBE, gapped DP, XMFA) runs redundantly and
    deterministically in every process on identical gathered inputs.
    The XMFA bytes are hash-compared across processes before returning
    (assert_processes_agree) so a divergence can never go unnoticed.

    Returns (IntervalList, MatchArray) in every process."""
    from libmems_tpu.aligner import AlignerConfig, align
    cfg = config or AlignerConfig()
    if cfg.mesh is None:
        import dataclasses
        cfg = dataclasses.replace(cfg, mesh=global_mesh())
    ivs, mums = align(genomes, cfg)
    assert_processes_agree("align/xmfa", _xmfa_bytes(ivs))
    return ivs, mums


def multihost_progressive_align(genomes, config=None):
    """END-TO-END progressive alignment across processes (PA.cpp:3779
    promoted; same contract as multihost_align).  Returns
    (IntervalList, guide tree) in every process, XMFA hash-verified."""
    from libmems_tpu.progressive import (ProgressiveConfig,
                                         progressive_align)
    cfg = config or ProgressiveConfig()
    if cfg.mesh is None:
        import dataclasses
        cfg = dataclasses.replace(cfg, mesh=global_mesh())
    ivs, tree = progressive_align(genomes, cfg)
    assert_processes_agree("progressive/xmfa", _xmfa_bytes(ivs))
    return ivs, tree


def multihost_find_mums(genomes, seed: int | None = None, mesh=None,
                        pairwise: bool = False, tiled: bool = False,
                        **kw):
    """Host-sharded end-to-end seeding: each process builds its owned
    SMLs, key tables are exchanged once, and the seed-prefix-sharded
    finder runs over the global mesh.  Every process receives the full
    MatchArray (results are allgathered).

    tiled=True routes extension through the position-tiled pipeline
    (sharded_find_mums_tiled): after the one-time table exchange NO
    device holds the full key table — per-DEVICE residency is
    O(total/n_dev), the multi-host analog of dmSML's per-scratch-disk
    residency.  Host-stepped probe rounds cost one scalar sync per
    round across all processes.

    The multi-host twin of MatchList::LoadSMLs + MemHash::FindMatches
    (MatchList.h:261-349, MemHash.cpp:109) with dmSML's cross-device
    partitioning promoted to processes."""
    from libmems_tpu.parallel.shard import (sharded_find_mums,
                                            sharded_find_mums_tiled,
                                            sharded_find_pairwise_mums)
    from libmems_tpu.sml import default_seed
    if seed is None:
        seed = default_seed(genomes)
    n = len(genomes)
    owned = build_owned_smls(genomes, seed)
    tables = gather_key_tables(owned, n, seed)
    if mesh is None:
        mesh = global_mesh()
    if pairwise:
        find = sharded_find_pairwise_mums
    elif tiled:
        find = sharded_find_mums_tiled
    else:
        find = sharded_find_mums
    return find(tables, mesh, **kw)
