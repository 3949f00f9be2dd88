"""External gapped-aligner adapters (subprocess MUSCLE / ClustalW).

Batched device alignment lives in libmems_tpu.msa (the in-process engine,
the analog of MuscleInterface::CallMuscleFast).  This module is the
analog of the reference's *subprocess* adapters:

* MuscleInterface::CallMuscle — pipe FastA to an external `muscle`
  binary via pipeExec and read the aligned FastA back
  (libMems/MuscleInterface.cpp:674-724);
* ClustalInterface — the same adapter pattern for `clustalw`
  (libMems/ClustalInterface.{h,cpp});
* failure handling — on a failed run, dump the input to a reproducer
  file `muscle_failure_N.txt` and continue unaligned
  (libMems/MuscleInterface.cpp:716-722).

Adapters satisfy the same call contract as msa.align_codes (list of
2-bit code arrays in, uint8 ASCII row matrix out), so an orchestrator
can swap them in wherever the in-process engine is used.  When the
external binary is missing the adapter reports unavailable and callers
fall back to the in-process engine.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile

import numpy as np

from libmems_tpu.sequence import translate_dna

_CODE_TO_ASCII = np.frombuffer(b"ACGT", dtype=np.uint8)
_failure_count = 0


def _codes_to_fasta(seqs: list[np.ndarray]) -> str:
    out = []
    for i, s in enumerate(seqs):
        out.append(f">seq{i}")
        out.append(_CODE_TO_ASCII[np.asarray(s, dtype=np.uint8)]
                   .tobytes().decode())
    return "\n".join(out) + "\n"


def _parse_fasta_rows(text: str, n: int) -> np.ndarray:
    chunks: dict[str, list[str]] = {}
    order: list[str] = []
    cur = None
    for line in text.splitlines():
        if line.startswith(">"):
            cur = line[1:].split()[0]
            order.append(cur)
            chunks[cur] = []
        elif cur is not None and line.strip():
            chunks[cur].append(line.strip())
    # restore input order (stable aligners keep names seq0..seqN-1)
    names = sorted(order, key=lambda s: int(s[3:]) if s.startswith("seq")
                   and s[3:].isdigit() else 0)
    rows = [np.frombuffer("".join(chunks[nm]).encode(), np.uint8)
            for nm in names]
    if len(rows) != n or len({len(r) for r in rows}) != 1:
        raise ValueError("external aligner returned malformed alignment")
    return np.stack(rows)


def _dump_failure(fasta: str, workdir: str | None = None) -> str:
    """Reproducer dump on aligner failure (MuscleInterface.cpp:716-722)."""
    global _failure_count
    path = os.path.join(workdir or os.getcwd(),
                        f"muscle_failure_{_failure_count}.txt")
    _failure_count += 1
    with open(path, "w") as fh:
        fh.write(fasta)
    return path


class ExternalGappedAligner:
    """Subprocess gapped-aligner adapter (pipeExec pattern).

    command: argv template; "{in}" / "{out}" placeholders are replaced
    with temp file paths; if absent, FastA is piped on stdin and the
    alignment read from stdout (muscle-style).
    """

    def __init__(self, command: list[str], name: str = "external",
                 timeout: float = 600.0, failure_dir: str | None = None):
        self.command = list(command)
        self.name = name
        self.timeout = timeout
        self.failure_dir = failure_dir

    def available(self) -> bool:
        return shutil.which(self.command[0]) is not None

    def align_codes(self, seqs: list[np.ndarray]) -> np.ndarray:
        """Align 2-bit code arrays; returns uint8[G, C] ASCII rows."""
        fasta = _codes_to_fasta(seqs)
        uses_files = any("{in}" in a or "{out}" in a for a in self.command)
        try:
            if uses_files:
                with tempfile.TemporaryDirectory() as td:
                    fin = os.path.join(td, "in.fa")
                    fout = os.path.join(td, "out.fa")
                    with open(fin, "w") as fh:
                        fh.write(fasta)
                    argv = [a.replace("{in}", fin).replace("{out}", fout)
                            for a in self.command]
                    subprocess.run(argv, check=True, capture_output=True,
                                   timeout=self.timeout)
                    with open(fout) as fh:
                        text = fh.read()
            else:
                proc = subprocess.run(
                    self.command, input=fasta.encode(), check=True,
                    capture_output=True, timeout=self.timeout)
                text = proc.stdout.decode()
            return _parse_fasta_rows(text, len(seqs))
        except (subprocess.SubprocessError, OSError, ValueError) as e:
            path = _dump_failure(fasta, self.failure_dir)
            raise RuntimeError(
                f"{self.name} failed ({e}); input dumped to {path}") from e


def muscle_adapter(binary: str = "muscle") -> ExternalGappedAligner:
    """MuscleInterface::CallMuscle equivalent (stdin/stdout pipe)."""
    return ExternalGappedAligner([binary, "-quiet", "-maxiters", "1"],
                                 name="muscle")


def clustalw_adapter(binary: str = "clustalw") -> ExternalGappedAligner:
    """ClustalInterface equivalent (file-based invocation)."""
    return ExternalGappedAligner(
        [binary, "-INFILE={in}", "-OUTFILE={out}", "-OUTPUT=FASTA",
         "-QUIET"], name="clustalw")


def align_codes_external_or_native(seqs: list[np.ndarray],
                                   adapter: ExternalGappedAligner | None
                                   ) -> np.ndarray:
    """Use the external adapter when available, else the in-process
    device engine (the reference's CallMuscleFast-vs-pipe split)."""
    if adapter is not None and adapter.available():
        try:
            return adapter.align_codes(seqs)
        except RuntimeError:
            pass  # reproducer dumped; fall through to native engine
    from libmems_tpu.msa import align_codes
    return align_codes(seqs)
