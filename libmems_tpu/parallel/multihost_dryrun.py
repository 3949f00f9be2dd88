"""Multi-process CPU dryrun of the multi-host sharded pipeline.

Two processes x four virtual CPU devices each, one 8-device global mesh:
every process builds only its OWNED genomes' SMLs (host-sharded index
construction), key tables are exchanged once, and the seed-prefix-
sharded finders run over the process-spanning mesh.  Each worker checks
bit-parity against its locally computed single-device result and prints
MULTIHOST_DRYRUN_OK.

Run the parent orchestration:

    python -m libmems_tpu.parallel.multihost_dryrun

or as a library: run_multihost_dryrun(nproc=2, local_devices=4).
This validates PROCESS TRANSPARENCY (BASELINE config 5's multi-host
shape); it measures nothing — real DCN scaling needs real hosts.
"""

from __future__ import annotations

import os
import subprocess
import sys


def _worker(coordinator: str, nproc: int, pid: int) -> None:
    import numpy as np

    from libmems_tpu.parallel import multihost as mh
    mh.initialize(coordinator, nproc, pid)

    import jax
    assert jax.process_count() == nproc, jax.process_count()

    from libmems_tpu import seeds as seedlib
    from libmems_tpu.matchfind import find_mums, find_pairwise_mums
    from libmems_tpu.sml import SortedMerList

    # deterministic family: every process generates identical inputs
    rng = np.random.default_rng(7)
    anc = rng.integers(0, 4, size=3000).astype(np.uint8)
    fam = []
    for _ in range(6):
        g = anc.copy()
        idx = rng.random(len(g)) < 0.02
        g[idx] = rng.integers(0, 4, size=int(idx.sum())).astype(np.uint8)
        fam.append(g)
    seed = seedlib.get_seed(9, 0)

    own = mh.owned_genomes(len(fam))
    assert own, "every process must own at least one genome"
    got = mh.multihost_find_mums(fam, seed)
    got_pw = mh.multihost_find_mums(fam, seed, pairwise=True)
    # position-tiled extension across processes: per-DEVICE residency
    # O(total/n_dev), host-stepped rounds synchronized via the psum'd
    # n_active scalar every process fetches identically
    got_tl = mh.multihost_find_mums(fam, seed, tiled=True)

    # single-device local reference (process-local devices only)
    smls = [SortedMerList.create(g, seed) for g in fam]
    ref = find_mums(smls)
    ref_pw = find_pairwise_mums(smls)
    assert got.key_set() == ref.key_set(), (len(got), len(ref))
    assert got_pw.key_set() == ref_pw.key_set(), (len(got_pw),
                                                  len(ref_pw))
    assert got_tl.key_set() == ref.key_set(), (len(got_tl), len(ref))

    # ---- END-TO-END alignment across the 2 processes (BASELINE
    # config 5): align() and progressive_align() run
    # to XMFA under jax.process_count()==2, and every process asserts
    # BYTE parity with its own single-process (mesh=None) result.
    from libmems_tpu.aligner import AlignerConfig
    from libmems_tpu.progressive import ProgressiveConfig
    from libmems_tpu.sequence import Genome

    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    genomes = [Genome(name=f"g{i}", ascii=lut[g], codes=g)
               for i, g in enumerate(fam[:4])]
    ivs_mh, _ = mh.multihost_align(
        genomes, AlignerConfig(seed=seed, recursive=False))
    ivs_1p, _ = __import__("libmems_tpu.aligner", fromlist=["align"]) \
        .align(genomes, AlignerConfig(seed=seed, recursive=False))
    assert mh._xmfa_bytes(ivs_mh) == mh._xmfa_bytes(ivs_1p), \
        "multihost align() != single-process align()"

    pcfg = ProgressiveConfig(seed=seed, refine=False, gap_search=False,
                             use_bp_distance=False)
    pivs_mh, _ = mh.multihost_progressive_align(genomes[:3], pcfg)
    from libmems_tpu.progressive import progressive_align
    pivs_1p, _ = progressive_align(genomes[:3], pcfg)
    assert mh._xmfa_bytes(pivs_mh) == mh._xmfa_bytes(pivs_1p), \
        "multihost progressive_align() != single-process"

    print(f"MULTIHOST_DRYRUN_OK pid={pid} owned={own} "
          f"mums={len(got)} pairwise={len(got_pw)} "
          f"tiled={len(got_tl)} e2e_align_intervals={len(ivs_mh.intervals)} "
          f"e2e_prog_intervals={len(pivs_mh.intervals)}", flush=True)


def run_multihost_dryrun(nproc: int = 2, local_devices: int = 4,
                         timeout: int = 2400) -> None:
    """timeout covers the worst case of cold CPU compile caches AND a
    CI box shared with other test workers (the e2e align cases roughly
    doubled worker runtime; measured ~10 min under xdist contention)."""
    """Spawn the worker fleet and verify every process reports parity."""
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    coordinator = f"localhost:{port}"

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (
        env.get("XLA_FLAGS", "").replace(
            "--xla_force_host_platform_device_count=8", "").strip()
        + f" --xla_force_host_platform_device_count={local_devices}"
    ).strip()
    env["JAX_CPU_COLLECTIVES_IMPLEMENTATION"] = "gloo"

    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "libmems_tpu.parallel.multihost_dryrun",
             "--worker", coordinator, str(nproc), str(pid)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        for pid in range(nproc)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0 or "MULTIHOST_DRYRUN_OK" not in out:
            raise RuntimeError(
                f"multihost dryrun worker {pid} failed "
                f"(rc={p.returncode}):\n{out[-4000:]}")
    print(f"multihost dryrun: {nproc} processes x {local_devices} "
          f"devices OK", flush=True)


def main(argv: list[str]) -> None:
    if len(argv) >= 4 and argv[0] == "--worker":
        _worker(argv[1], int(argv[2]), int(argv[3]))
    else:
        run_multihost_dryrun()


if __name__ == "__main__":
    main(sys.argv[1:])
