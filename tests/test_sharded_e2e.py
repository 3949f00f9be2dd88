"""End-to-end mesh-routed pipelines (BASELINE config 5 as an
*alignment*, not just a MUM parity check): align()/progressive_align()
with cfg.mesh set run seeding through the seed-prefix-sharded pipeline
on the virtual 8-device mesh and must produce byte-identical XMFA to
the single-device path — the ParallelMemHash property (same interface,
fanned out; libMems/ParallelMemHash.cpp:42-121, Aligner.cpp:2193)."""

import io

import numpy as np
import pytest

import jax

from libmems_tpu.matchfind import find_pairwise_mums
from libmems_tpu.parallel.shard import (make_mesh,
                                        sharded_find_pairwise_mums)
from libmems_tpu.sequence import Genome
from libmems_tpu.sml import SortedMerList
from libmems_tpu import seeds as seedlib

pytestmark = pytest.mark.slow  # multi-minute integration module

needs_mesh = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8-device mesh")

LUT = np.frombuffer(b"ACGT", dtype=np.uint8)


def _family(rng, n_genomes, length, mutate=0.02, rearrange=0):
    anc = rng.integers(0, 4, size=length).astype(np.uint8)
    out = []
    for _ in range(n_genomes):
        g = anc.copy()
        idx = rng.random(length) < mutate
        g[idx] = rng.integers(0, 4, size=int(idx.sum())).astype(np.uint8)
        for _ in range(rearrange):
            a = int(rng.integers(0, length - 400))
            b = a + int(rng.integers(100, 400))
            seg = 3 - g[a:b][::-1]
            g = np.concatenate([g[:a], seg, g[b:]])
        out.append(g)
    return out


def _genomes(arrs):
    return [Genome(name=f"g{i}", ascii=LUT[a], codes=a)
            for i, a in enumerate(arrs)]


def _xmfa_bytes(ivs):
    from libmems_tpu.interval import write_xmfa
    buf = io.StringIO()
    write_xmfa(buf, ivs)
    return buf.getvalue()


@needs_mesh
def test_sharded_pairwise_seeder_parity():
    rng = np.random.default_rng(0)
    genomes = _family(rng, 5, 4000)
    seed = seedlib.get_seed(9, 0)
    smls = [SortedMerList.create(g, seed) for g in genomes]
    want = find_pairwise_mums(smls)
    got = sharded_find_pairwise_mums(smls, make_mesh(8))
    assert got.key_set() == want.key_set()
    assert len(got) > 0


@needs_mesh
def test_sharded_pairwise_overflow_retry():
    rng = np.random.default_rng(1)
    genomes = _family(rng, 3, 3000)
    seed = seedlib.get_seed(9, 0)
    smls = [SortedMerList.create(g, seed) for g in genomes]
    want = find_pairwise_mums(smls)
    got = sharded_find_pairwise_mums(smls, make_mesh(8), capacity=256,
                                     route_cap=256, max_retries=10)
    assert got.key_set() == want.key_set()


@needs_mesh
def test_flat_align_mesh_e2e_parity():
    """30 genomes end to end: sharded seeding -> overlaps -> LCB/GBE ->
    gapped intervals -> XMFA, byte-equal to the unsharded pipeline."""
    from libmems_tpu.aligner import AlignerConfig, align

    rng = np.random.default_rng(2)
    genomes = _genomes(_family(rng, 30, 1500, mutate=0.01))
    base = AlignerConfig(gapped_alignment=True, recursive=False)
    ivs_ref, mums_ref = align(genomes, base)
    mesh_cfg = AlignerConfig(gapped_alignment=True, recursive=False,
                             mesh=make_mesh(8))
    ivs_got, mums_got = align(genomes, mesh_cfg)
    assert mums_got.key_set() == mums_ref.key_set()
    assert _xmfa_bytes(ivs_got) == _xmfa_bytes(ivs_ref)
    assert len(ivs_got.intervals) > 0


@needs_mesh
def test_flat_align_mesh_accepts_device_count():
    from libmems_tpu.aligner import AlignerConfig, align

    rng = np.random.default_rng(3)
    genomes = _genomes(_family(rng, 3, 2000))
    ivs_ref, _ = align(genomes, AlignerConfig())
    ivs_got, _ = align(genomes, AlignerConfig(mesh=8))
    assert _xmfa_bytes(ivs_got) == _xmfa_bytes(ivs_ref)


@needs_mesh
def test_progressive_align_mesh_e2e_parity():
    from libmems_tpu.progressive import ProgressiveConfig, \
        progressive_align

    rng = np.random.default_rng(4)
    genomes = _genomes(_family(rng, 5, 3000, mutate=0.015, rearrange=1))
    ivs_ref, _ = progressive_align(
        genomes, ProgressiveConfig(refine=False))
    ivs_got, _ = progressive_align(
        genomes, ProgressiveConfig(refine=False, mesh=make_mesh(8)))
    assert _xmfa_bytes(ivs_got) == _xmfa_bytes(ivs_ref)
    assert len(ivs_got.intervals) > 0


def test_mesh_supports_tolerant_search():
    """repeat_tolerance>0 routes through the sharded pipeline too
    and reproduces the single-device XMFA.  The
    old ValueError rejection is gone."""
    from libmems_tpu.aligner import AlignerConfig, align

    rng = np.random.default_rng(5)
    genomes = _genomes(_family(rng, 2, 3000))
    ivs_ref, _ = align(genomes, AlignerConfig(repeat_tolerance=1,
                                              recursive=False))
    ivs_got, _ = align(genomes, AlignerConfig(
        mesh=make_mesh(8), repeat_tolerance=1, recursive=False))
    assert _xmfa_bytes(ivs_got) == _xmfa_bytes(ivs_ref)
