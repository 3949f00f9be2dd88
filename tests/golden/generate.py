"""Self-golden generation for the BASELINE configs (scaled to CPU).

The reference cannot be built here (see README.md),
so these goldens pin THIS pipeline's own byte output for scaled-down
versions of BASELINE configs 1-4.  Any silent output drift between
rounds fails tests/test_golden.py; intentional changes re-run
``python -m tests.golden.generate`` and review the diff.

All inputs are seeded synthetic genomes; every pipeline stage involved
is deterministic (fixed RNG seeds, stable sorts, no wall-clock input).
"""

from __future__ import annotations

import io
import os

import numpy as np

GOLDEN_DIR = os.path.dirname(os.path.abspath(__file__))

_LUT = np.frombuffer(b"ACGT", dtype=np.uint8)


def _mutant(rng, anc, mutate=0.01, indel=0.0005, invert=None):
    g = anc.copy()
    idx = rng.random(len(g)) < mutate
    g[idx] = rng.integers(0, 4, size=int(idx.sum())).astype(np.uint8)
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
    if invert is not None:
        a, b = invert
        g = np.concatenate([g[:a], 3 - g[a:b][::-1], g[b:]])
    return g


def _genomes_pair(n=60_000):
    from libmems_tpu.sequence import Genome
    rng = np.random.default_rng(1001)
    anc = rng.integers(0, 4, size=n).astype(np.uint8)
    b = _mutant(rng, anc, invert=(20_000, 28_000))
    return [Genome("gA", _LUT[anc], filename="gA.fa"),
            Genome("gB", _LUT[b], filename="gB.fa")]


def _genomes_three(n=40_000):
    from libmems_tpu.sequence import Genome
    rng = np.random.default_rng(1002)
    anc = rng.integers(0, 4, size=n).astype(np.uint8)
    out = [anc] + [_mutant(rng, anc) for _ in range(2)]
    return [Genome(f"g{i}", _LUT[g], filename=f"g{i}.fa")
            for i, g in enumerate(out)]


def _genomes_nine(n=20_000):
    from libmems_tpu.sequence import Genome
    rng = np.random.default_rng(1004)
    anc = rng.integers(0, 4, size=n).astype(np.uint8)
    out = []
    for gi in range(9):
        inv = (6_000, 9_000) if gi % 3 == 1 else None
        out.append(_mutant(rng, anc, mutate=0.012, invert=inv))
    return [Genome(f"e{i}", _LUT[g], filename=f"e{i}.fa")
            for i, g in enumerate(out)]


def config1_mums() -> bytes:
    """Config 1: pairwise MUM list, match-list v3 text format."""
    from libmems_tpu.match import write_match_list
    from libmems_tpu.matchfind import find_mums
    gs = _genomes_pair()
    mums = find_mums(gs)
    buf = io.StringIO()
    write_match_list(buf, mums, [g.filename for g in gs],
                     [len(g) for g in gs])
    return buf.getvalue().encode()


def config2_mums3() -> bytes:
    """Config 2: three-genome multi-MUM list."""
    from libmems_tpu.match import write_match_list
    from libmems_tpu.matchfind import find_mums
    gs = _genomes_three()
    mums = find_mums(gs)
    buf = io.StringIO()
    write_match_list(buf, mums, [g.filename for g in gs],
                     [len(g) for g in gs])
    return buf.getvalue().encode()


def config3_xmfa() -> bytes:
    """Config 3: pairwise LCBs + gapped intervals -> XMFA."""
    from libmems_tpu.aligner import AlignerConfig, align
    from libmems_tpu.interval import write_xmfa
    gs = _genomes_pair()
    ivs, _ = align(gs, AlignerConfig(gapped_alignment=True))
    buf = io.StringIO()
    write_xmfa(buf, ivs)
    return buf.getvalue().encode()


def config4_outputs() -> dict[str, bytes]:
    """Config 4: 9-genome progressive + backbone -> XMFA, bbseq, bbcols."""
    from libmems_tpu.backbone import (apply_backbone,
                                      write_backbone_columns,
                                      write_backbone_seq_coordinates)
    from libmems_tpu.interval import write_xmfa
    from libmems_tpu.progressive import ProgressiveConfig, progressive_align
    gs = _genomes_nine()
    ivs, _ = progressive_align(gs, ProgressiveConfig(refine=False))
    new_ivs, segments = apply_backbone(ivs)
    xmfa = io.StringIO()
    write_xmfa(xmfa, new_ivs)
    bbseq = io.StringIO()
    write_backbone_seq_coordinates(bbseq, segments, len(gs))
    bbcols = io.StringIO()
    write_backbone_columns(bbcols, segments)
    return {"nine.xmfa": xmfa.getvalue().encode(),
            "nine.bbseq": bbseq.getvalue().encode(),
            "nine.bbcols": bbcols.getvalue().encode()}


def all_outputs() -> dict[str, bytes]:
    out = {"pair.mums": config1_mums(),
           "three.mums": config2_mums3(),
           "pair.xmfa": config3_xmfa()}
    out.update(config4_outputs())
    return out


def main():
    for name, data in all_outputs().items():
        path = os.path.join(GOLDEN_DIR, name)
        with open(path, "wb") as fh:
            fh.write(data)
        print(f"wrote {name}: {len(data)} bytes")


if __name__ == "__main__":
    main()
