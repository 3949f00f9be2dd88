"""Multi-process (multi-host shape) dryrun under pytest: 2 processes x
4 virtual CPU devices, one global mesh — host-sharded SML build,
key-table exchange, sharded finders, per-worker bit-parity
(libmems_tpu/parallel/multihost_dryrun.py)."""

import pytest

pytestmark = pytest.mark.slow


def test_two_process_dryrun_parity():
    """Includes the END-TO-END cases: align() and progressive_align()
    to XMFA under jax.process_count()==2, byte-parity per process
    (BASELINE config 5)."""
    from libmems_tpu.parallel.multihost_dryrun import run_multihost_dryrun
    run_multihost_dryrun(nproc=2, local_devices=4)


def test_single_process_wrappers():
    """multihost_align / multihost_progressive_align degrade to the
    plain pipelines in a single process (tripwire is a no-op; the mesh
    defaults to all local devices)."""
    import numpy as np

    from libmems_tpu.aligner import AlignerConfig, align
    from libmems_tpu.parallel import multihost as mh
    from libmems_tpu.progressive import ProgressiveConfig
    from libmems_tpu.sequence import Genome

    mh.assert_processes_agree("noop", b"x")    # single-process no-op

    rng = np.random.default_rng(3)
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    anc = rng.integers(0, 4, 2500).astype(np.uint8)
    fam = []
    for i in range(3):
        g = anc.copy()
        idx = rng.random(len(g)) < 0.02
        g[idx] = rng.integers(0, 4, int(idx.sum()))
        fam.append(Genome(name=f"g{i}", ascii=lut[g], codes=g))

    ivs_mh, _ = mh.multihost_align(
        fam, AlignerConfig(recursive=False))
    ivs_1p, _ = align(fam, AlignerConfig(
        recursive=False, mesh=mh.global_mesh()))
    assert mh._xmfa_bytes(ivs_mh) == mh._xmfa_bytes(ivs_1p)

    pivs, _ = mh.multihost_progressive_align(
        fam, ProgressiveConfig(refine=False, gap_search=False,
                               use_bp_distance=False))
    assert len(pivs.intervals) > 0
