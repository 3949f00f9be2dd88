"""Run the aligner's main paths once on a GPU and check them against the
repo's plain references.

    python chip_smoke.py              # one card: goldens, E. coli-scale
                                      # pair, 9 x 1 Mbp progressive +
                                      # backbone, kernels vs references
    python chip_smoke.py --chips 4    # the sharded paths on four cards,
                                      # against the one-mesh-less runs

The card's name and power limit come first on stdout, then one line
per phase with its seconds and the XLA compiles it triggered, and the
LAST stdout line is one JSON object naming the device JAX used.  A
failed phase makes the script exit non-zero (its traceback goes to
stderr) and the JSON line is never printed.  There is no CPU fallback:
without a GPU backend the script fails at phase 0.

Phases (one card):

0. device check: `jax.default_backend() == "gpu"`, `nvidia-smi` name and
   power limit; with several cards visible the process is pinned to the
   first one before JAX starts.
1. goldens: `tests/golden/generate.all_outputs()` byte-equal to the
   committed files (flat aligner, multi-MUM anchoring, progressive
   alignment, HomologyHMM backbone).
2. 2 x 4.6 Mbp pair (BASELINE configs 1 and 3) -> `align()` with
   gapped alignment -> XMFA -> `read_xmfa`; the device MUM set equals
   the numpy twin `find_pair_mums_np` exactly; quality floors of
   `tests/test_quality_gate.py`; no host fallback fired.
3. 9 x 1 Mbp progressive + refinement + backbone (BASELINE config 4)
   -> XMFA, bbseq, bbcols; `validate_interval_list` and quality floors.
4. kernels at real widths: profile Gotoh DP (gate bucket and small
   buckets) against the same call on the CPU backend; the five
   HomologyHMM forward/backward entry points against the bfloat oracle
   `tests/oracle/refimpl_l5.py`.  The extension fetch is checked through
   phase 2's MUM parity.
"""

from __future__ import annotations

import json
import os
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# --- sizes (the deployments users align; BASELINE.md configs) ---------
PAIR_LEN = 4_600_000                 # E. coli-scale pair, configs 1 and 3
FAMILY = (9, 1_000_000)              # config 4: 9 genomes x 1 Mbp
PROFILE_GATE = (256, 2560)           # refine-gate bucket: windows x cols
PROFILE_SMALL = (400, (16, 64))      # inter-anchor windows, 16/64 buckets
PROFILE_CPU_SAMPLE = 32              # gate windows re-run on the CPU
HMM_ASSOC = (8, 1 << 20)             # _fb_calls_assoc batch x columns
HMM_ORACLE_ROWS = 2                  # assoc rows re-run by the oracle

# --- tolerances --------------------------------------------------------
# profile DP (float32, einsums at Precision.HIGHEST): scores may differ
# from the CPU backend only by summation order; tracebacks must match
PROFILE_RTOL = 1e-5
PROFILE_ATOL = 0.5
# HomologyHMM: float32 log-space device kernels vs the extended-exponent
# float64 oracle; posteriors within HMM_ATOL, calls 100 % equal outside
# columns whose oracle posterior lies within HMM_MARGIN of the threshold
HMM_ATOL = 2e-4
HMM_MARGIN = 1e-3

FALLBACK_COUNTERS = ("host_fallback/sml_out_of_core",
                     "host_fallback/pairwise_mums_host")


class PhaseError(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def log(msg):
    print(msg, flush=True)


def result_line(platform: str, kind: str, count: int) -> str:
    """The script's last stdout line."""
    return json.dumps({"ok": True, "device": {
        "platform": platform, "kind": kind, "count": count}})


def pin_devices(chips: int) -> None:
    """Expose exactly `chips` cards (before JAX starts), and keep the
    CPU backend beside the GPU for the profile-DP parity check."""
    from bench import pin_cards
    pin_cards(chips)
    plats = os.environ.get("JAX_PLATFORMS")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"


class CompileCounter:
    """Counts XLA backend compiles and persistent-cache hits/misses."""

    def __init__(self):
        import jax
        self.compiles = 0
        self.compile_s = 0.0
        self.events: dict[str, int] = {}

        def on_duration(event, duration, **_):
            if event == "/jax/core/compile/backend_compile_duration":
                self.compiles += 1
                self.compile_s += duration

        def on_event(event, **_):
            if event.startswith("/jax/compilation_cache/cache_"):
                self.events[event] = self.events.get(event, 0) + 1

        jax.monitoring.register_event_duration_secs_listener(on_duration)
        jax.monitoring.register_event_listener(on_event)

    def snapshot(self):
        return (self.compiles, self.compile_s,
                self.events.get("/jax/compilation_cache/cache_hits", 0),
                self.events.get("/jax/compilation_cache/cache_misses", 0))


def _genomes(arrays, prefix="g"):
    import numpy as np
    from libmems_tpu.sequence import Genome
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    return [Genome(name=f"{prefix}{i}", ascii=lut[a], codes=a)
            for i, a in enumerate(arrays)]


def _assert_no_fallback():
    from libmems_tpu import trace
    fired = {k: v for k, v in trace.counters().items()
             if k in FALLBACK_COUNTERS and v}
    check(not fired, f"host fallback fired: {fired}")


# ---------------------------------------------------------------------
# phase 1: goldens
# ---------------------------------------------------------------------

def phase_goldens():
    from tests.golden import generate
    drift = []
    for name, data in generate.all_outputs().items():
        with open(os.path.join(generate.GOLDEN_DIR, name), "rb") as fh:
            if fh.read() != data:
                drift.append(name)
    check(not drift, f"golden drift on this device: {drift}")
    return "6 golden files byte-equal"


# ---------------------------------------------------------------------
# phase 2: E. coli-scale pair
# ---------------------------------------------------------------------

def pair_quality_ok(q: dict, n: int) -> None:
    """tests/test_quality_gate.py::test_pair_config_quality_floor."""
    check(q["multi_aligned_base_frac"] > 0.99, f"pair coverage {q}")
    check(q["sp_score"] > 84 * n, f"pair SP {q}")
    check(q["core_columns"] > 0.97 * n, f"pair core columns {q}")


def phase_pair(length: int = PAIR_LEN, workdir: str = "."):
    from bench import _synthetic_pair
    from libmems_tpu import trace
    from libmems_tpu.aligner import AlignerConfig, align
    from libmems_tpu.interval import read_xmfa, write_xmfa
    from libmems_tpu.matchfind import find_mums, find_pair_mums_np
    from libmems_tpu.scoring import alignment_quality_stats
    from libmems_tpu.sml import create_smls

    a, b = _synthetic_pair(length)
    genomes = _genomes([a, b])
    trace.reset()
    t0 = time.perf_counter()
    ivs, _ = align(genomes, AlignerConfig(gapped_alignment=True))
    path = os.path.join(workdir, "pair.xmfa")
    write_xmfa(path, ivs)
    t_align = time.perf_counter() - t0
    _assert_no_fallback()
    back = read_xmfa(path)
    check(len(back) == len(ivs.intervals) > 0,
          f"XMFA round trip: {len(back)} vs {len(ivs.intervals)}")

    smls, seed = create_smls(genomes)
    dev = find_mums(smls)
    ref = find_pair_mums_np(a, b, seed)
    dk, rk = dev.key_set(), ref.key_set()
    check(dk == rk, f"MUM parity: device {len(dk)}, numpy twin {len(rk)},"
          f" {len(dk ^ rk)} differ")

    q = alignment_quality_stats(ivs)
    pair_quality_ok(q, len(genomes[0]))
    return (f"align+XMFA {t_align:.2f} s, {len(ivs.intervals)} intervals, "
            f"{len(dk)} MUMs equal to the numpy twin, quality {q}")


# ---------------------------------------------------------------------
# phase 3: 9 x 1 Mbp progressive + backbone
# ---------------------------------------------------------------------

def family_quality_ok(q: dict, G: int, n: int) -> None:
    """tests/test_quality_gate.py::test_progressive_quality_floor, with
    the SP floor (0.8 x 899*n at G=5, i.e. 0.8 x 89.9 per genome pair
    and column) scaled to G genomes."""
    pairs = G * (G - 1) // 2
    check(q["multi_aligned_base_frac"] > 0.98, f"family coverage {q}")
    check(q["core_columns"] > 0.95 * n, f"family core columns {q}")
    check(q["sp_score"] > 0.8 * 89.9 * pairs * n, f"family SP {q}")


def phase_progressive(n_genomes: int = FAMILY[0], length: int = FAMILY[1],
                      workdir: str = "."):
    from bench_e2e import _mutant_family
    from libmems_tpu import trace
    from libmems_tpu.backbone import (apply_backbone,
                                      write_backbone_columns,
                                      write_backbone_seq_coordinates)
    from libmems_tpu.interval import read_xmfa, write_xmfa
    from libmems_tpu.progressive import ProgressiveConfig, progressive_align
    from libmems_tpu.scoring import alignment_quality_stats
    from libmems_tpu.validate import validate_interval_list

    genomes = _genomes(_mutant_family(n_genomes, length))
    trace.reset()
    t0 = time.perf_counter()
    ivs, _ = progressive_align(genomes, ProgressiveConfig())
    t1 = time.perf_counter()
    new_ivs, segments = apply_backbone(ivs)
    write_xmfa(os.path.join(workdir, "nine.xmfa"), new_ivs)
    write_backbone_seq_coordinates(os.path.join(workdir, "nine.bbseq"),
                                   segments, n_genomes)
    write_backbone_columns(os.path.join(workdir, "nine.bbcols"), segments)
    t2 = time.perf_counter()
    _assert_no_fallback()
    validate_interval_list(ivs)
    validate_interval_list(new_ivs)
    back = read_xmfa(os.path.join(workdir, "nine.xmfa"))
    check(len(back) == len(new_ivs.intervals) > 0, "XMFA round trip")
    check(len(segments) > 0, "no backbone segments")
    q = alignment_quality_stats(ivs)
    family_quality_ok(q, n_genomes, length)
    return (f"progressive {t1 - t0:.2f} s, backbone+write {t2 - t1:.2f} s,"
            f" {len(new_ivs.intervals)} intervals, {len(segments)} "
            f"backbone segments, quality {q}")


# ---------------------------------------------------------------------
# phase 4: kernels against references
# ---------------------------------------------------------------------

def profile_windows(n: int, cols, rng_seed: int = 0, rows: int = 8):
    """Single-row-bipartition refine windows: p is one genome's segment
    with a few indels, q is `rows` aligned relatives of it (1-2 %
    substitutions, a sprinkling of gap columns).  `cols` is a width or a
    tuple of widths cycled over the windows."""
    import numpy as np
    rng = np.random.default_rng(rng_seed)
    widths = cols if isinstance(cols, tuple) else (cols,)
    P, Q = [], []
    for w in range(n):
        c = int(widths[w % len(widths)])
        c = max(4, c - int(rng.integers(0, max(c // 8, 1))))
        anc = rng.integers(0, 4, c).astype(np.uint8)
        q = np.stack([np.where(rng.random(c) < 0.015,
                               rng.integers(0, 4, c), anc)
                      for _ in range(rows)]).astype(np.uint8)
        q[:, rng.random(c) < 0.01] = 4
        q = q[:, (q != 4).any(axis=0)]
        p = np.where(rng.random(c) < 0.01, rng.integers(0, 4, c), anc)
        p = p[rng.random(c) > 0.004].astype(np.uint8)
        P.append(p[None, :])
        Q.append(q)
    return P, Q


def check_profile_dp(n: int, cols, cpu_sample: int | None, rng_seed: int):
    """align_profile_batch / profile_scores_batch on the default device
    against the same calls on the CPU backend (a sample of windows)."""
    import jax
    import numpy as np
    from libmems_tpu.ops.profile import (align_profile_batch,
                                         profile_scores_batch)
    P, Q = profile_windows(n, cols, rng_seed)
    dev_s = profile_scores_batch(P, Q)
    dev_tb = align_profile_batch(P, Q)
    idx = list(range(n)) if cpu_sample is None else \
        sorted(np.random.default_rng(rng_seed).choice(
            n, size=min(cpu_sample, n), replace=False).tolist())
    with jax.default_device(jax.devices("cpu")[0]):
        ref_s = profile_scores_batch([P[i] for i in idx], [Q[i] for i in idx])
        ref_tb = align_profile_batch([P[i] for i in idx],
                                     [Q[i] for i in idx], mesh=None)
    d = np.abs(dev_s[idx] - ref_s)
    lim = PROFILE_RTOL * np.abs(ref_s) + PROFILE_ATOL
    check(bool((d <= lim).all()),
          f"profile scores: max |gpu-cpu| {d.max():.4g} over limit "
          f"(windows {[idx[i] for i in np.flatnonzero(d > lim)][:8]})")
    bad = [i for k, i in enumerate(idx)
           if not np.array_equal(dev_tb[i], ref_tb[k])]
    check(not bad, f"profile tracebacks differ on windows {bad[:8]}")
    return f"{len(idx)}/{n} windows equal (max score diff {d.max():.3g})"


def hmm_sequences(n: int, length: int, rng_seed: int):
    """Encoded column-symbol sequences of homologous pairs with an
    unrelated stretch; lengths spread over (length/2, length]."""
    import numpy as np
    from libmems_tpu.islands import encode_column_states
    rng = np.random.default_rng(rng_seed)
    out = []
    for _ in range(n):
        m = int(rng.integers(length // 2 + 16, length + 1))
        a = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=m)
        b = a.copy()
        sub = rng.random(m) < 0.05
        b[sub] = rng.choice(np.frombuffer(b"ACGT", np.uint8),
                            size=int(sub.sum()))
        lo = int(rng.integers(0, m // 2))
        hi = lo + m // 4
        b[lo:hi] = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=hi - lo)
        gap = rng.random(m) < 0.02
        side = rng.random(m) < 0.5
        a[gap & side] = ord("-")
        b[gap & ~side] = ord("-")
        sym, _ = encode_column_states(a, b)
        out.append(sym[:length])
    return out


def _oracle_posteriors(seq, params):
    import numpy as np
    from tests.oracle.refimpl_l5 import run_oracle
    states = "".join(chr(ord("1") + int(c)) for c in seq)
    return np.asarray(run_oracle(states, params)[1])


def check_hmm(assoc=HMM_ASSOC, oracle_rows: int = HMM_ORACLE_ROWS,
              rng_seed: int = 0):
    """The five forward/backward entry points, each at a bucket that
    routes to it, against the bfloat oracle."""
    import numpy as np
    from libmems_tpu.ops import hmm
    params = hmm.hoxd_params()
    thr = hmm.POSTERIOR_THRESHOLD
    small, ckpt = 1 << 12, 1 << 15
    check(small < hmm._FB_CKPT_MIN_T <= ckpt < hmm._FB_ASSOC_MIN_T
          <= assoc[1], "HMM tier cut-offs moved; resize the check")
    notes = []

    def cmp_post(name, seqs, got):
        worst = 0.0
        for s, g in zip(seqs, got):
            want = _oracle_posteriors(s, params)
            worst = max(worst, float(np.abs(g - want).max()))
        check(worst <= HMM_ATOL, f"{name}: posterior diff {worst:.3g}")
        notes.append(f"{name} max|dp| {worst:.2g}")

    def cmp_calls(name, seqs, got):
        n_cols = n_excl = 0
        for s, g in zip(seqs, got):
            want = _oracle_posteriors(s, params)
            sure = np.abs(want - thr) > HMM_MARGIN
            bad = int(((g != (want >= thr)) & sure).sum())
            check(bad == 0, f"{name}: {bad} calls differ from the oracle")
            n_cols += len(s)
            n_excl += int((~sure).sum())
        notes.append(f"{name} {n_cols} cols ({n_excl} in margin)")

    seqs = hmm_sequences(8, small, rng_seed)
    cmp_post("_fb_posterior", seqs, hmm.posterior_homologous(seqs, params))
    cmp_calls("_fb_calls_small", seqs, hmm.predict_homologous(seqs, params))
    seqs = hmm_sequences(4, ckpt, rng_seed + 1)
    cmp_post("_fb_posterior_ckpt", seqs,
             hmm.posterior_homologous(seqs, params))
    cmp_calls("_fb_calls_ckpt", seqs, hmm.predict_homologous(seqs, params))
    seqs = hmm_sequences(assoc[0], assoc[1], rng_seed + 2)
    got = hmm.predict_homologous(seqs, params)
    check(all(len(g) == len(s) for g, s in zip(got, seqs)), "assoc shapes")
    cmp_calls("_fb_calls_assoc", seqs[:oracle_rows], got[:oracle_rows])
    return "; ".join(notes)


def phase_kernels(gate=PROFILE_GATE, small=PROFILE_SMALL,
                  cpu_sample=PROFILE_CPU_SAMPLE, assoc=HMM_ASSOC,
                  oracle_rows=HMM_ORACLE_ROWS):
    notes = [
        "profile gate " + check_profile_dp(gate[0], gate[1], cpu_sample, 1),
        "profile small " + check_profile_dp(small[0], small[1], None, 2),
        "hmm " + check_hmm(assoc, oracle_rows),
    ]
    return "; ".join(notes)


# ---------------------------------------------------------------------
# --chips 4: the sharded paths against the single-device results
# ---------------------------------------------------------------------

def phase_mesh(n_dev: int = 4, pair_len: int = PAIR_LEN, family=FAMILY):
    import io

    import jax
    from bench import _synthetic_pair
    from bench_e2e import _mutant_family
    from libmems_tpu.aligner import AlignerConfig, align
    from libmems_tpu.interval import write_xmfa
    from libmems_tpu.matchfind import find_mums, find_pairwise_mums
    from libmems_tpu.parallel import make_mesh
    from libmems_tpu.parallel.shard import (sharded_find_mums,
                                            sharded_find_mums_tiled,
                                            sharded_find_pairwise_mums)
    from libmems_tpu.progressive import ProgressiveConfig, progressive_align
    from libmems_tpu.sml import create_smls

    check(len(jax.devices()) >= n_dev,
          f"{len(jax.devices())} devices, need {n_dev}")
    mesh = make_mesh(n_dev)
    notes = []

    def timed(label, fn):     # logged as it ends: a cut run still shows
        t0 = time.perf_counter()
        out = fn()
        notes.append(f"{label} {time.perf_counter() - t0:.2f} s")
        log(f"#   mesh: {notes[-1]}")
        return out

    pair = _genomes(list(_synthetic_pair(pair_len)))
    smls, _ = create_smls(pair)
    ref = timed("find_mums", lambda: find_mums(smls)).key_set()
    got = timed("sharded_find_mums",
                lambda: sharded_find_mums(smls, mesh)).key_set()
    check(got == ref, f"sharded_find_mums: {len(got ^ ref)} MUMs differ")
    fam = _genomes(_mutant_family(*family))
    fsmls, _ = create_smls(fam)
    ref = timed("find_pairwise_mums",
                lambda: find_pairwise_mums(fsmls)).key_set()
    got = timed("sharded_find_pairwise_mums",
                lambda: sharded_find_pairwise_mums(fsmls, mesh)).key_set()
    check(got == ref, f"sharded_find_pairwise_mums: {len(got ^ ref)} differ")

    def xmfa(ivs):
        buf = io.StringIO()
        write_xmfa(buf, ivs)
        return buf.getvalue()

    for m in (None, n_dev):
        cfg = AlignerConfig(gapped_alignment=True, mesh=m)
        out = timed(f"align(mesh={m})", lambda: xmfa(align(pair, cfg)[0]))
        if m is None:
            ref = out
    check(out == ref, "align(mesh) XMFA differs from mesh=None")
    for m in (None, n_dev):
        cfg = ProgressiveConfig(mesh=m)
        out = timed(f"progressive_align(mesh={m})",
                    lambda: xmfa(progressive_align(fam, cfg)[0]))
        if m is None:
            ref = out
    check(out == ref, "progressive_align(mesh) XMFA differs from mesh=None")

    # last: host-stepped probe rounds, one collective step per round
    ref = find_mums(smls).key_set()
    got = timed("sharded_find_mums_tiled",
                lambda: sharded_find_mums_tiled(smls, mesh)).key_set()
    check(got == ref, f"sharded_find_mums_tiled: {len(got ^ ref)} differ")
    return "; ".join(notes)


# ---------------------------------------------------------------------

def run_phases(phases, counter) -> list[str]:
    failed = []
    for name, fn in phases:
        c0 = counter.snapshot()
        t0 = time.perf_counter()
        try:
            note = fn()
            status = "ok"
        except Exception as e:     # report every phase, then fail
            import traceback
            traceback.print_exc()
            note = f"{type(e).__name__}: {e}"
            status = "FAILED"
            failed.append(name)
        c1 = counter.snapshot()
        log(f"# phase {name}: {status} {time.perf_counter() - t0:.2f} s, "
            f"{c1[0] - c0[0]} compiles ({c1[1] - c0[1]:.1f} s), "
            f"cache hits {c1[2] - c0[2]} misses {c1[3] - c0[3]} | {note}")
    return failed


def main(argv: list[str]) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1)
    args = ap.parse_args(argv)

    sys.path.insert(0, REPO)
    pin_devices(args.chips)
    import tempfile

    import jax
    import libmems_tpu  # noqa: F401  (x64, compile cache)

    t0 = time.perf_counter()
    backend = jax.default_backend()
    if backend != "gpu":
        log(f"# phase device: FAILED, JAX backend is {backend!r}, not 'gpu'")
        return 2
    devs = jax.devices()
    if len(devs) != args.chips:
        log(f"# phase device: FAILED, {len(devs)} devices, "
            f"expected {args.chips}")
        return 2
    from bench import card_name_and_power
    print(card_name_and_power(), flush=True)
    log(f"# phase device: ok {time.perf_counter() - t0:.2f} s | "
        f"{devs[0].platform} {devs[0].device_kind} x{len(devs)}, "
        f"jax {jax.__version__}")

    counter = CompileCounter()
    with tempfile.TemporaryDirectory() as td:
        if args.chips == 1:
            phases = [("goldens", phase_goldens),
                      ("pair", lambda: phase_pair(workdir=td)),
                      ("progressive", lambda: phase_progressive(workdir=td)),
                      ("kernels", phase_kernels)]
        else:
            phases = [("mesh", lambda: phase_mesh(args.chips))]
        failed = run_phases(phases, counter)
    if failed:
        log(f"# FAILED phases: {failed}")
        return 1
    print(result_line(devs[0].platform, devs[0].device_kind, len(devs)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
