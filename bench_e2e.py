"""End-to-end wall-clock benchmarks (BASELINE.md configs 1/3/4).

Runs on one GPU (refuses any other backend; every JSON line names the
device kind and count and the card's nvidia-smi name and power limit):
  A. 2 x 4.6 Mbp synthetic pair -> align() (LCBs + gapped intervals) ->
     XMFA (config 1+3)
  B. 9 x ~1 Mbp synthetic enterobacteria-like set -> progressive_align
     (refine=True, the default) -> backbone detection+application ->
     XMFA (config 4)

Prints one JSON line per phase to stdout.  Every number the README
publishes comes from these JSON lines (`--render-readme` rewrites the
README table from the recorded results — one source of truth).

Timing labels (compile cost is paid once per kernel shape via the
persistent cache, so these differ a lot):

  value / *_s          first run in THIS process: includes jit tracing
                       + cached-executable loads (warm cache) or full
                       compiles (cold cache).  The JSON records which
                       via "cache": "warm"|"cold".
  marginal_s           a SECOND, different input in the same process —
                       the per-alignment cost a long-running service
                       sees.
  --cold               run with the persistent cache switched off, so
                       every kernel compiles: the first-ever-run number.

Quality stats ride along: sum-of-pairs score and
column/coverage stats of the final XMFA, so content regressions are
visible independently of byte-golden stability.
"""

import json
import os
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
RESULTS_PATH = os.path.join(REPO, "bench_results.json")

_COLD = False      # set by --cold
_DEVICE: dict = {}


def _emit(obj):
    obj = {**obj, **_DEVICE}
    if _COLD:
        # --cold results are their own metric: they must not overwrite
        # the steady-state entry in the accumulator
        obj["metric"] += "_cold"
    print(json.dumps(obj), flush=True)
    # keep the latest result per metric for --render-readme
    try:
        with open(RESULTS_PATH) as fh:
            acc = json.load(fh)
    except (OSError, ValueError):
        acc = {}
    acc[obj["metric"]] = obj
    with open(RESULTS_PATH + ".tmp", "w") as fh:
        json.dump(acc, fh, indent=1, sort_keys=True)
    os.replace(RESULTS_PATH + ".tmp", RESULTS_PATH)


def _mutant_family(n_genomes, length, rng_seed=0, mutate=0.01,
                   indel=0.0002, rearrange=2, ancestor=None):
    """Star-phylogeny family: independent mutants of one ancestor with a
    couple of segmental rearrangements each."""
    import numpy as np
    rng = np.random.default_rng(rng_seed)
    if ancestor is not None:
        anc = ancestor
        length = len(anc)
    else:
        anc = rng.integers(0, 4, size=length).astype(np.uint8)
    out = []
    for gi in range(n_genomes):
        g = anc.copy()
        idx = rng.random(length) < mutate
        g[idx] = rng.integers(0, 4, size=int(idx.sum())).astype(np.uint8)
        if indel > 0:
            sites = np.flatnonzero(rng.random(len(g)) < indel)
            parts, cur = [], 0
            for s in sites:
                if s < cur:
                    continue
                z = int(rng.geometric(0.5))
                parts.append(g[cur:s])
                if rng.random() < 0.5:
                    parts.append(rng.integers(0, 4, size=z).astype(np.uint8))
                    cur = s
                else:
                    cur = s + z
            parts.append(g[cur:])
            g = np.concatenate(parts)
        for _ in range(rearrange):
            L = len(g)
            a = int(rng.integers(0, L - 20_000))
            b = a + int(rng.integers(5_000, 20_000))
            seg = g[a:b]
            if rng.random() < 0.5:  # inversion
                seg = 3 - seg[::-1]
                g = np.concatenate([g[:a], seg, g[b:]])
            else:                   # translocation
                rest = np.concatenate([g[:a], g[b:]])
                at = int(rng.integers(0, len(rest)))
                g = np.concatenate([rest[:at], seg, rest[at:]])
        out.append(g)
    return out


def _repeat_rich_ancestor(length, rng_seed=1234):
    """Ancestor with PLANTED repeat families — the structure real
    bacterial genomes carry and uniform-random synthetics lack: a
    30-copy 1.5 kb IS-element-like family, a 7-copy 5 kb
    rRNA-operon-like family, and a 12-copy 300 bp
    REP-element-like family, copies diverged 1-3% from their consensus.
    These stress the 1000-occurrence mer cutoff (MatchFinder.cpp:166
    semantics), overlap clustering (Aligner.cpp:62-178) and the
    uniqueness-scaled anchor scores (GBE.h:437-450)."""
    import numpy as np
    rng = np.random.default_rng(rng_seed)
    anc = rng.integers(0, 4, size=length).astype(np.uint8)
    for elem_len, copies, div in ((1500, 30, 0.02), (5000, 7, 0.01),
                                  (300, 12, 0.03)):
        elem = rng.integers(0, 4, size=elem_len).astype(np.uint8)
        for _ in range(copies):
            pos = int(rng.integers(0, length - elem_len))
            cp = elem.copy()
            idx = rng.random(elem_len) < div
            cp[idx] = rng.integers(0, 4, size=int(idx.sum()))
            if rng.random() < 0.5:
                cp = (3 - cp[::-1]).astype(np.uint8)   # inverted copy
            anc[pos:pos + elem_len] = cp
    return anc


def repeat_rich_pair(length=2_000_000, rng_seed=0):
    """Two mutants (1% subs + indels + rearrangements) of a planted-
    repeat ancestor; shared by the benchmark phase and the quality-gate
    test."""
    anc = _repeat_rich_ancestor(length)
    return _mutant_family(2, length, rng_seed=rng_seed, ancestor=anc)


def phase_repeat_rich_pair(tmpdir, length=2_000_000):
    import numpy as np
    from libmems_tpu import trace
    from libmems_tpu.aligner import AlignerConfig, align
    from libmems_tpu.interval import write_xmfa
    from libmems_tpu.sequence import Genome

    cache = _cache_state()
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)

    def run(rng_seed, out):
        a, b = repeat_rich_pair(length, rng_seed=rng_seed)
        genomes = [Genome(name="A", ascii=lut[a], codes=a),
                   Genome(name="B", ascii=lut[b], codes=b)]
        t0 = time.perf_counter()
        ivs, mums = align(genomes, AlignerConfig(gapped_alignment=True,
                                                 recursive=False))
        write_xmfa(out, ivs)
        return time.perf_counter() - t0, ivs, mums

    from libmems_tpu.ops import profile as _prof
    trace.set_enabled(True)
    trace.reset()
    dt1, ivs, mums = run(0, f"{tmpdir}/rep.xmfa")
    _prof.BAND_STATS.update(dict.fromkeys(_prof.BAND_STATS, 0))
    trace.reset()
    dt2, ivs2, _ = run(1, f"{tmpdir}/rep2.xmfa")
    stages = trace.stage_seconds()
    trace.set_enabled(False)
    bases = 2 * length    # nominal (indels shift each mutant by ~0.1%)
    _emit({
        "metric": "repeat_rich_pair_s", "value": round(dt1, 2),
        "unit": "s", "cache": cache, "bases": bases,
        "n_mums": len(mums), "n_intervals": len(ivs.intervals),
        "marginal_s": round(dt2, 2),
        "marginal_bases_per_s": round(bases / dt2, 1),
        "marginal_stages_s": stages,
        "marginal_band_stats": dict(_prof.BAND_STATS),
        **_quality_stats(ivs)})


def phase_trio_to_xmfa(tmpdir, length=1_500_000):
    """BASELINE config 2: three-genome multi-MUM anchoring (MemHash
    multi-match semantics + MatchList filtering) through the flat
    aligner to XMFA — the one BASELINE config the pair/progressive
    phases don't cover.  Exercises the G>2 fused MUM pipeline
    (find_mums_device) at its bucket-stable shapes."""
    import numpy as np
    from libmems_tpu import trace
    from libmems_tpu.aligner import AlignerConfig, align
    from libmems_tpu.interval import write_xmfa
    from libmems_tpu.sequence import Genome

    cache = _cache_state()
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)

    def run(rng_seed, out):
        fam = _mutant_family(3, length, rng_seed=rng_seed)
        genomes = [Genome(name=f"g{i}", ascii=lut[g], codes=g)
                   for i, g in enumerate(fam)]
        t0 = time.perf_counter()
        ivs, mums = align(genomes, AlignerConfig(gapped_alignment=True,
                                                 recursive=False))
        write_xmfa(out, ivs)
        total = sum(len(g) for g in fam)
        return time.perf_counter() - t0, total, ivs, mums

    trace.set_enabled(True)
    trace.reset()
    dt1, total, ivs, mums = run(0, f"{tmpdir}/trio.xmfa")
    trace.reset()
    dt2a, _, _, _ = run(1, f"{tmpdir}/trio2.xmfa")
    trace.reset()
    dt2, m_total, ivs2, _ = run(2, f"{tmpdir}/trio3.xmfa")
    stages = trace.stage_seconds()
    trace.set_enabled(False)
    _emit({
        "metric": "trio_align_to_xmfa_s", "value": round(dt1, 2),
        "unit": "s", "cache": cache, "bases": total,
        "n_mums": len(mums), "n_intervals": len(ivs.intervals),
        "bases_per_s": round(total / dt1, 1),
        "marginal_s": round(dt2, 2),
        "marginal_first_s": round(dt2a, 2),
        "marginal_bases_per_s": round(m_total / dt2, 1),
        "marginal_stages_s": stages,
        **_quality_stats(ivs)})


def _cache_state() -> str:
    """'warm' when the persistent compile cache in force has entries."""
    import jax
    if not jax.config.jax_enable_compilation_cache:
        return "cold"
    d = jax.config.jax_compilation_cache_dir
    try:
        return "warm" if d and os.listdir(d) else "cold"
    except OSError:
        return "cold"


def _quality_stats(ivs):
    from libmems_tpu.scoring import alignment_quality_stats
    return alignment_quality_stats(ivs)


def phase_pair_to_xmfa(tmpdir):
    from bench import _synthetic_pair
    import numpy as np
    from libmems_tpu import trace
    from libmems_tpu.aligner import AlignerConfig, align
    from libmems_tpu.interval import write_xmfa
    from libmems_tpu.sequence import Genome

    cache = _cache_state()
    L = 4_600_000
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)

    def run(rng_seed, out):
        a, b = _synthetic_pair(L, rng_seed=rng_seed)
        genomes = [Genome(name="A", ascii=lut[a], codes=a),
                   Genome(name="B", ascii=lut[b], codes=b)]
        t0 = time.perf_counter()
        ivs, mums = align(genomes, AlignerConfig(gapped_alignment=True,
                                                 recursive=False))
        write_xmfa(out, ivs)
        return time.perf_counter() - t0, ivs, mums

    trace.set_enabled(True)
    trace.reset()
    dt1, ivs, mums = run(0, f"{tmpdir}/pair.xmfa")
    # marginal: DIFFERENT genome pairs in the same process — the
    # per-alignment cost a long-running service sees.  Two different
    # second inputs are run and the LAST is reported: the first
    # marginal run can still pay one-time compiles or executable loads
    # for padded shapes the warmup input didn't produce
    trace.reset()
    dt2a, _, _ = run(1, f"{tmpdir}/pair2.xmfa")
    trace.reset()
    dt2, ivs2, _ = run(2, f"{tmpdir}/pair3.xmfa")
    stages = trace.stage_seconds()
    trace.set_enabled(False)
    _emit({
        "metric": "pair_align_to_xmfa_s", "value": round(dt1, 2),
        "unit": "s", "cache": cache, "bases": 2 * L,
        "n_mums": len(mums), "n_intervals": len(ivs.intervals),
        "bases_per_s": round(2 * L / dt1, 1),
        "marginal_s": round(dt2, 2),
        "marginal_first_s": round(dt2a, 2),
        "marginal_bases_per_s": round(2 * L / dt2, 1),
        "marginal_stages_s": stages,
        **_quality_stats(ivs)})


def phase_progressive_9(tmpdir, n=9, length=1_000_000):
    import numpy as np
    from libmems_tpu import trace
    from libmems_tpu.backbone import (apply_backbone,
                                      write_backbone_columns,
                                      write_backbone_seq_coordinates)
    from libmems_tpu.interval import write_xmfa
    from libmems_tpu.progressive import ProgressiveConfig, progressive_align
    from libmems_tpu.sequence import Genome

    cache = _cache_state()
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)

    def run(rng_seed, tag):
        fam = _mutant_family(n, length, rng_seed=rng_seed)
        genomes = [Genome(name=f"g{i}", ascii=lut[g], codes=g)
                   for i, g in enumerate(fam)]
        t0 = time.perf_counter()
        # refine=True IS the default (PA.cpp:1118 refineAlignment runs
        # by default in the reference); its cost is reported separately
        ivs, tree = progressive_align(genomes, ProgressiveConfig())
        t1 = time.perf_counter()
        new_ivs, segments = apply_backbone(ivs)
        write_xmfa(f"{tmpdir}/{tag}.xmfa", new_ivs)
        write_backbone_seq_coordinates(f"{tmpdir}/{tag}.bbseq",
                                       segments, n)
        write_backbone_columns(f"{tmpdir}/{tag}.bbcols", segments)
        t2 = time.perf_counter()
        total = sum(len(g) for g in fam)
        return (t0, t1, t2, total, ivs, new_ivs, segments)

    from libmems_tpu.ops import profile as _prof
    trace.set_enabled(True)
    trace.reset()
    t0, t1, t2, total, ivs, new_ivs, segments = run(0, "nine")
    stages = trace.stage_seconds()
    _prof.BAND_STATS.update(dict.fromkeys(_prof.BAND_STATS, 0))
    # marginal: a SECOND, different 9-genome family in the same
    # process — the per-alignment cost once executables are resident
    trace.reset()
    m0, m1, m2, m_total, m_ivs, _, _ = run(1, "nine2")
    m_stages = trace.stage_seconds()
    trace.set_enabled(False)
    refine_s = stages.get("refine", 0.0)
    _emit({
        "metric": "progressive9_to_xmfa_s", "value": round(t2 - t0, 2),
        "unit": "s", "cache": cache, "bases": total,
        "align_s": round(t1 - t0, 2),
        "refine_s": round(refine_s, 2),
        "align_no_refine_s": round(t1 - t0 - refine_s, 2),
        "backbone_s": round(t2 - t1, 2),
        "n_intervals": len(new_ivs.intervals),
        "n_backbone_segments": len(segments),
        "bases_per_s": round(total / (t2 - t0), 1),
        "stages_s": stages,
        "marginal_s": round(m2 - m0, 2),
        "marginal_bases_per_s": round(m_total / (m2 - m0), 1),
        "marginal_stages_s": m_stages,
        "marginal_band_stats": dict(_prof.BAND_STATS),
        **_quality_stats(ivs)})


README_BEGIN = "<!-- BENCH_E2E_TABLE_BEGIN -->"
README_END = "<!-- BENCH_E2E_TABLE_END -->"


def render_block(acc: dict) -> str:
    """Render the README table block from a bench_results accumulator
    (pure; tests assert README.md contains exactly this rendering of
    the committed bench_results.json — drift is impossible).  The line
    above the table names the card(s) the rows were measured on."""
    cards = sorted({f"{r['card']} ({r['device_kind']} x"
                    f"{r['device_count']})"
                    for r in acc.values() if isinstance(r, dict)
                    and "card" in r})
    lines = [
        README_BEGIN,
        "<!-- generated by `python bench_e2e.py --render-readme`;"
        " do not edit by hand -->",
        "Measured on: " + ("; ".join(cards) or "not measured") + "  ",
        "",
        "| benchmark | first-in-process | marginal | quality |",
        "|---|---|---|---|",
    ]
    p = acc.get("pair_align_to_xmfa_s")
    if p:
        lines.append(
            f"| 2 x 4.6 Mbp pair -> LCBs -> gapped XMFA | "
            f"{p['value']} s ({p['cache']} cache) | "
            f"{p['marginal_s']} s ({p['marginal_bases_per_s'] / 1e6:.2f}"
            f" Mbases/s) | SP {p['sp_score']:.3g}, "
            f"{p['multi_aligned_base_frac'] * 100:.1f}% bases aligned |")
    t = acc.get("trio_align_to_xmfa_s")
    if t:
        lines.append(
            f"| 3 x {t['bases'] // 3 / 1e6:.1f} Mbp multi-MUM anchoring "
            f"-> flat XMFA | "
            f"{t['value']} s ({t['cache']} cache) | "
            f"{t['marginal_s']} s ({t['marginal_bases_per_s'] / 1e6:.2f}"
            f" Mbases/s) | SP {t['sp_score']:.3g}, "
            f"{t['multi_aligned_base_frac'] * 100:.1f}% bases aligned |")
    q = acc.get("progressive9_to_xmfa_s")
    if q:
        marg = (f"{q['marginal_s']} s "
                f"({q['marginal_bases_per_s'] / 1e6:.2f} Mbases/s)"
                if q.get("marginal_s") else "—")
        lines.append(
            f"| 9 x 1 Mbp progressive + backbone -> XMFA | "
            f"{q['value']} s ({q['cache']} cache; align "
            f"{q['align_s']} s of which refine {q['refine_s']} s, "
            f"backbone {q['backbone_s']} s) | {marg} | "
            f"SP {q['sp_score']:.3g}, "
            f"{q['multi_aligned_base_frac'] * 100:.1f}% bases aligned |")
    r = acc.get("repeat_rich_pair_s")
    if r:
        lines.append(
            f"| 2 x {r['bases'] // 2 / 1e6:.1f} Mbp repeat-rich pair "
            f"(IS elements + operons) -> XMFA | "
            f"{r['value']} s ({r['cache']} cache) | "
            f"{r['marginal_s']} s ({r['marginal_bases_per_s'] / 1e6:.2f}"
            f" Mbases/s) | SP {r['sp_score']:.3g}, "
            f"{r['multi_aligned_base_frac'] * 100:.1f}% bases aligned |")
    c = acc.get("pair_align_to_xmfa_s_cold")
    if c:
        lines.append(
            f"| 2 x 4.6 Mbp pair, no compile cache (first-ever run) | "
            f"{c['value']} s | {c['marginal_s']} s | — |")
    m = acc.get("mum_find_bases_per_s")
    if m:
        lines.append(
            f"| MUM discovery kernel (bench.py) | — | "
            f"{m['value'] / 1e6:.1f} Mbases/s ({m['vs_baseline']:.1f}x "
            f"single-core numpy twin) | — |")
    lines.append(README_END)
    return "\n".join(lines)


def render_readme():
    """Rewrite README.md's e2e performance table from bench_results.json
    (one source of truth).  Called automatically at
    the end of every bench_e2e run (the discipline
    must not depend on remembering to re-run it)."""
    with open(RESULTS_PATH) as fh:
        acc = json.load(fh)
    block = render_block(acc)

    readme = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "README.md")
    with open(readme) as fh:
        text = fh.read()
    b = text.find(README_BEGIN)
    e = text.find(README_END)
    if b < 0 or e < 0:
        raise SystemExit(
            f"README.md lacks {README_BEGIN}/{README_END} markers")
    text = text[:b] + block + text[e + len(README_END):]
    with open(readme, "w") as fh:
        fh.write(text)
    print(f"README table regenerated from {RESULTS_PATH}")


def main():
    global _COLD, _DEVICE
    import tempfile
    if "--render-readme" in sys.argv:
        render_readme()
        return
    from bench import gpu_device_record, pin_cards
    pin_cards(1)
    _DEVICE = gpu_device_record()
    if "--cold" in sys.argv:
        # no persistent cache in this process: every kernel compiles,
        # the first-ever-run cost; the cache directory is left alone
        import jax
        import libmems_tpu  # noqa: F401  (its cache settings first)
        jax.config.update("jax_enable_compilation_cache", False)
        _COLD = True
    only = {a for a in sys.argv[1:] if a.endswith("-only")}
    with tempfile.TemporaryDirectory() as td:
        if not only or "--pair-only" in only:
            phase_pair_to_xmfa(td)
        if (not only and "--no-trio" not in sys.argv) \
                or "--trio-only" in only:
            phase_trio_to_xmfa(td)
        if not only or "--nine-only" in only:
            phase_progressive_9(td)
        if ((not only and "--repeat" in sys.argv)
                or "--repeat-only" in only):
            phase_repeat_rich_pair(td)
    # every bench run rewrites the README table — numbers can't drift
    render_readme()


if __name__ == "__main__":
    main()
