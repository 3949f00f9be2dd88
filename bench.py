"""Benchmark: MUM discovery throughput (bases/s) on one GPU.

Runs the fused device pipeline (packed seed-word sort -> neighbor-compare
run flags -> diagonal-cluster sort -> representative compaction ->
span-seeded batched ungapped extension -> dedup) on a synthetic
E. coli-scale pair (2 x 4.6 Mbp, 1% substitutions + 0.05% indels, the
indels giving the realistic diagonal-breaking structure of a true
genome pair) and prints ONE JSON line.

vs_baseline: ratio against a single-core CPU reference throughput for
the SAME full pipeline (pack, sort, run flags, cluster, compact,
extend, dedup) measured once per run with numpy on a sample (the
reference C++ library publishes no numbers and cannot be built here —
BASELINE.md / tests/golden/README.md; the numpy twin stands in for the
reference's fill+sort+stream-merge+ExtendMatch loops).

A per-stage device-time table is printed to stderr (lines prefixed
'# stage'); stdout carries only the JSON line.  The script refuses to
run on any backend but a GPU, holds one card, and names that card
(device kind, count, nvidia-smi name and power limit) in its result.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np


def pin_cards(n: int = 1) -> None:
    """Expose only the first n visible cards to this process; call it
    before JAX starts (the gapped-DP mesh spans every local card)."""
    vis = os.environ.get("CUDA_VISIBLE_DEVICES")
    ids = [d for d in vis.split(",") if d.strip()] if vis else \
        [str(i) for i in range(n)]
    os.environ["CUDA_VISIBLE_DEVICES"] = ",".join(ids[:n])


def card_name_and_power() -> str:
    """`name, power.limit` of the cards, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip()


def gpu_device_record() -> dict:
    """The device fields every benchmark result carries.  Exits when
    JAX has no GPU backend: a benchmark never falls back to the CPU."""
    import jax
    if jax.default_backend() != "gpu":
        raise SystemExit(f"JAX backend is {jax.default_backend()!r}, not "
                         "'gpu': refusing to benchmark")
    devs = jax.devices()
    return {"platform": devs[0].platform,
            "device_kind": devs[0].device_kind,
            "device_count": len(devs),
            "card": card_name_and_power()}


def _synthetic_pair(n, rng_seed=0, mutate=0.01, indel=0.0005):
    """Divergent genome pair: substitutions break spaced-seed windows,
    indels shift diagonals (without them a spaced seed extends through
    every isolated substitution and the pair collapses to one MUM)."""
    rng = np.random.default_rng(rng_seed)
    a = rng.integers(0, 4, size=n).astype(np.uint8)
    b = a.copy()
    idx = rng.random(n) < mutate
    b[idx] = rng.integers(0, 4, size=int(idx.sum())).astype(np.uint8)
    if indel > 0:
        sites = np.flatnonzero(rng.random(n) < indel)
        sizes = rng.geometric(0.5, size=len(sites))
        parts, cur = [], 0
        for s, z in zip(sites, sizes):
            if s < cur:
                continue
            parts.append(b[cur:s])
            if rng.random() < 0.5:   # insertion
                parts.append(rng.integers(0, 4, size=z).astype(np.uint8))
                cur = s
            else:                    # deletion
                cur = s + int(z)
        parts.append(b[cur:])
        b = np.concatenate(parts)[:n]
    return a, b


def _cpu_full_pipeline_np(codes_a, codes_b, seed):
    """Single-core numpy twin of the device fast path: identical
    algorithm (pack -> sort -> neighbor flags -> cluster sort -> rep
    compaction -> span-seeded extension -> dedup), so bases/s compares
    the same work on one CPU core vs one GPU.  The implementation
    lives in libmems_tpu.matchfind.find_pair_mums_np (it doubles as the
    host path for small gap searches)."""
    from libmems_tpu.matchfind import find_pair_mums_np

    m = find_pair_mums_np(codes_a, codes_b, seed)
    return np.stack([m.starts[:, 0], m.starts[:, 1], m.lengths], axis=1)


def _cpu_reference_bases_per_s(codes_a, codes_b, seed, sample=1 << 20,
                               reps=5):
    """Median-of-`reps` single-core twin throughput + relative spread.

    Pinned methodology (a single-shot measurement
    swung the published vs_baseline 48x->28x between runs with zero
    code change): one untimed warmup, `reps` timed runs, median
    throughput, spread = (max-min)/median of the timed runs recorded in
    the JSON so an unstable box is visible in the artifact."""
    a = codes_a[:sample]
    b = codes_b[:sample]
    _ = _cpu_full_pipeline_np(a, b, seed)          # warmup (allocators)
    times = []
    for _i in range(reps):
        t0 = time.perf_counter()
        _ = _cpu_full_pipeline_np(a, b, seed)
        times.append(time.perf_counter() - t0)
    med = float(np.median(times))
    spread = (max(times) - min(times)) / med
    return (len(a) + len(b)) / med, spread


def _stage_table(smls, chunk, ec):
    """Per-stage device times (separately-jitted stages; the fused
    pipeline overlaps some of these, so the table over-counts slightly)."""
    import jax
    import jax.numpy as jnp
    from libmems_tpu import matchfind as mf

    seed_len = smls[0].seed_length
    pb = mf._pair_pos_bits(max(s.n_windows for s in smls))
    u = jnp.uint64

    def timed(name, fn, *args):
        out = fn(*args)
        jax.block_until_ready(out)
        leaf = jax.tree_util.tree_leaves(out)[0]
        _ = np.asarray(leaf[:1] if leaf.ndim else leaf)
        t0 = time.perf_counter()
        for _i in range(3):
            out = fn(*args)
            jax.block_until_ready(out)
            leaf = jax.tree_util.tree_leaves(out)[0]
            _ = np.asarray(leaf[:1] if leaf.ndim else leaf)
        dt = (time.perf_counter() - t0) / 3
        print(f"# stage {name:28s} {dt * 1000:8.2f} ms", file=sys.stderr)
        return out

    ka, kb = smls[0].keys, smls[1].keys

    @jax.jit
    def s1(ka, kb):
        def pack(keys, gid):
            content = (keys >> 1).astype(u)
            strand = (keys & 1).astype(u)
            pos = jnp.arange(keys.shape[0], dtype=jnp.uint32).astype(u)
            return (content << u(pb + 2)) | (u(gid) << u(pb + 1)) \
                | (pos << u(1)) | strand
        return jax.lax.sort(jnp.concatenate([pack(ka, 0), pack(kb, 1)]))

    w = timed("seed-word sort (9.2M u64)", s1, ka, kb)

    @jax.jit
    def s2(w):
        c = w >> u(pb + 2)
        inf = ~jnp.zeros((1,), c.dtype)
        c1 = jnp.concatenate([c[1:], inf >> u(pb + 2)])
        c2 = jnp.concatenate([c[2:], jnp.broadcast_to(inf >> u(pb + 2), (2,))])
        cp = jnp.concatenate([inf, c[:-1]])
        gid = ((w >> u(pb + 1)) & u(1)).astype(jnp.uint32)
        g1 = jnp.concatenate([gid[1:], jnp.zeros((1,), jnp.uint32)])
        surv = (c == c1) & (c != cp) & (c1 != c2) & (gid == 0) & (g1 == 1)
        return surv

    surv = timed("pair-run flags (neighbors)", s2, w)

    @jax.jit
    def s3(w, surv):
        pos = ((w >> u(1)) & u((1 << pb) - 1)).astype(jnp.int32)
        strand = (w & u(1)).astype(jnp.uint32)
        posA, posB = pos, jnp.concatenate([pos[1:], jnp.zeros((1,), jnp.int32)])
        fwd = strand == jnp.concatenate([strand[1:], jnp.zeros((1,), jnp.uint32)])
        delta_b = jnp.where(fwd, (posB - posA + (1 << pb)).astype(u),
                            (posB + posA).astype(u))
        cw = (fwd.astype(u) << u(2 * pb + 2)) | (delta_b << u(pb)) \
            | posA.astype(u)
        return jax.lax.sort(jnp.where(surv, cw, ~u(0)))

    cw = timed("cluster sort (diag|posA)", s3, w, surv)
    full = lambda: mf.find_mums_device(smls, extend_capacity=ec, chunk=chunk)
    timed("FULL fused pipeline", full)


def main():
    pin_cards(1)
    import jax
    from libmems_tpu import seeds as seedlib
    from libmems_tpu.matchfind import find_mums_device
    from libmems_tpu.sml import SortedMerList

    device = gpu_device_record()
    L = 4_600_000
    seed = seedlib.get_seed(15, 0)
    codes_a, codes_b = _synthetic_pair(L)

    cpu_bps, cpu_spread = _cpu_reference_bases_per_s(codes_a, codes_b,
                                                     seed)

    smls = [SortedMerList.create(codes_a, seed),
            SortedMerList.create(codes_b, seed)]

    EC = 1 << 14
    CHUNK = None   # library default: shares the compile-cache entry with
                   # find_mums' production path

    def run(ec):
        starts, lengths, valid, n_rows, n_reps = find_mums_device(
            smls, extend_capacity=ec, chunk=CHUNK)
        return int(n_rows), int(n_reps)

    n_rows, n_reps = run(EC)  # compile + warm
    while n_reps > EC:        # capacity overflow: retry bigger
        EC <<= 2
        n_rows, n_reps = run(EC)
    iters = 5
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        run(EC)
        times.append(time.perf_counter() - t0)
    dt = float(np.median(times))
    dev_spread = (max(times) - min(times)) / dt

    bases = 2 * L
    bps = bases / dt
    if "--stages" in sys.argv:
        _stage_table(smls, CHUNK, EC)
    print(f"# device {dt * 1000:.1f} ms/iter, n_reps={n_reps}, "
          f"cpu twin {cpu_bps / 1e6:.2f} Mbases/s", file=sys.stderr)
    # ONE source of truth: `value` is the fetch-
    # synchronized figure (result scalars read back to host — what a
    # caller actually observes); README/PERF tables quote these fields
    # verbatim, never a separately-measured number.
    result = {
        "metric": "mum_find_bases_per_s",
        "value": round(bps, 1),
        "unit": "bases/s",
        "vs_baseline": round(bps / cpu_bps, 3),
        "ms_per_iter_fetch_sync": round(dt * 1000, 1),
        "bases": bases,
        "cpu_twin_bases_per_s": round(cpu_bps, 1),
        "cpu_twin_spread": round(cpu_spread, 3),
        "device_spread": round(dev_spread, 3),
        **device,
    }
    print(json.dumps(result))
    # record into the shared results file so README tables regenerate
    # from bench output, never hand-typed (bench_e2e.py --render-readme)
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "bench_results.json")
    try:
        with open(path) as fh:
            acc = json.load(fh)
    except (OSError, ValueError):
        acc = {}
    acc[result["metric"]] = result
    with open(path + ".tmp", "w") as fh:
        json.dump(acc, fh, indent=1, sort_keys=True)
    os.replace(path + ".tmp", path)
    # keep the README table in lockstep (tests/test_readme_table.py
    # fails on drift)
    try:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        from bench_e2e import render_readme
        render_readme()
    except Exception as e:
        print(f"# README render skipped: {e}", file=sys.stderr)


if __name__ == "__main__":
    main()
