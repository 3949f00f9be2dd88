"""Full sharded MUM pipeline (M7): parity with the single-device path
on a virtual 8-device CPU mesh (reference analog: dmSML key-range
partitioning + ParallelMemHash chunking, unified as seed-prefix
sharding)."""

import numpy as np
import pytest

from libmems_tpu import seeds as seedlib
from libmems_tpu.matchfind import find_mums
from libmems_tpu.parallel.shard import make_mesh, sharded_find_mums
from libmems_tpu.sml import SortedMerList

pytestmark = pytest.mark.slow  # multi-minute integration module

rng = np.random.default_rng(0)


def mutate(s, rate):
    out = s.copy()
    idx = rng.random(len(s)) < rate
    out[idx] = rng.integers(0, 4, size=int(idx.sum()))
    return out


@pytest.fixture(scope="module")
def smls():
    seed = seedlib.get_seed(11, 0)
    a = rng.integers(0, 4, size=20000).astype(np.uint8)
    b = mutate(a, 0.02)
    c = mutate(a, 0.03)
    c = np.concatenate([c[:7000], (3 - c[7000:14000])[::-1], c[14000:]])
    return [SortedMerList.create(x, seed) for x in (a, b, c)]


def test_sharded_matches_single_device(smls):
    ref = find_mums(smls)
    mesh = make_mesh(8)
    got = sharded_find_mums(smls, mesh, capacity=16384)
    assert ref.key_set() == got.key_set()


def test_sharded_two_devices(smls):
    ref = find_mums(smls)
    got = sharded_find_mums(smls, make_mesh(2), capacity=16384)
    assert ref.key_set() == got.key_set()


def test_sharded_repeat_tolerance_parity():
    """Tolerant repeat search on the mesh: genomes
    carrying a 2-copy repeat family must yield the same match set as
    the single-device tolerant path (MemHash::m_repeat_tolerance fanned
    through one interface, ParallelMemHash.cpp:42-121)."""
    seed = seedlib.get_seed(11, 0)
    r = np.random.default_rng(5)
    core = r.integers(0, 4, size=12000).astype(np.uint8)
    elem = r.integers(0, 4, size=800).astype(np.uint8)
    # two copies of the element per genome: seeds inside are non-unique
    # (killed at tolerance 0, enumerated at tolerance 1)
    a = np.concatenate([core[:4000], elem, core[4000:8000], elem,
                        core[8000:]])
    b = mutate(a, 0.01)
    smls2 = [SortedMerList.create(x, seed) for x in (a, b)]
    for tol in (1, 2):
        ref = find_mums(smls2, repeat_tolerance=tol)
        got = sharded_find_mums(smls2, make_mesh(8), capacity=16384,
                                repeat_tolerance=tol)
        assert ref.key_set() == got.key_set(), tol
    # tolerance widens the match set on this input
    assert len(find_mums(smls2, repeat_tolerance=1)) > \
        len(find_mums(smls2))


def test_sharded_overflow_detection(smls):
    # max_retries=0: the error path needs one compile, not four
    with pytest.raises(ValueError, match="capacity"):
        sharded_find_mums(smls, make_mesh(8), capacity=8, max_retries=0)


def test_sharded_overflow_auto_retry(smls, monkeypatch):
    """Undersized capacity/routing buffers recover by doubling-and-
    retrying (never a wrong result): parity with the single-device path
    from an undersized starting capacity.  Capacities start just below
    the requirement (each retry recompiles at new static shapes, ~60 s
    apiece on the CPU mesh); the spy asserts the retry path really
    ran."""
    from libmems_tpu.parallel import shard as sh
    calls = []
    orig = sh._sharded_find_mums_once

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(sh, "_sharded_find_mums_once", spy)
    ref = find_mums(smls)
    got = sharded_find_mums(smls, make_mesh(4), capacity=2048,
                            route_cap=2048, max_retries=8)
    assert ref.key_set() == got.key_set()
    assert len(calls) >= 2, "retry path was not exercised"


@pytest.fixture(scope="module")
def small_smls():
    seed = seedlib.get_seed(9, 0)
    a = rng.integers(0, 4, size=6000).astype(np.uint8)
    b = mutate(a, 0.02)
    b = np.concatenate([b[3000:], (3 - b[:3000])[::-1]])
    return [SortedMerList.create(x, seed) for x in (a, b)]


def test_tiled_extension_parity(small_smls):
    """Position-tiled extension (request/response span gather; no device
    holds the full key table) matches the single-device path."""
    from libmems_tpu.parallel.shard import sharded_find_mums_tiled
    ref = find_mums(small_smls)
    got = sharded_find_mums_tiled(small_smls, make_mesh(4),
                                  capacity=2048)
    assert ref.key_set() == got.key_set()


def test_tiled_extension_req_cap_retry(small_smls, monkeypatch):
    """Undersized span-request capacity recovers by doubling (fetch
    drops are counted and retried, never silently truncating
    matches); the spy asserts the retry really ran."""
    from libmems_tpu.parallel import shard as sh
    from libmems_tpu.parallel.shard import sharded_find_mums_tiled
    calls = []
    orig = sh._sharded_tiled_once

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(sh, "_sharded_tiled_once", spy)
    ref = find_mums(small_smls)
    got = sharded_find_mums_tiled(small_smls, make_mesh(4),
                                  capacity=2048, req_cap=512,
                                  max_retries=8)
    assert ref.key_set() == got.key_set()
    assert len(calls) >= 2, "retry path was not exercised"
