"""Sorted Mer List (SML): canonical spaced-seed mer index of one genome.

Device equivalent of the reference's SortedMerList / DNAMemorySML /
DNAFileSML (libMems/SortedMerList.{h,cpp}, MemorySML.cpp, FileSML.cpp).
Where the reference fills a bmer array with a sequential rolling 2-bit
window and std::sorts 16-byte records, here the whole index is three
device arrays produced by vector ops + one `jax.lax.sort`:

* ``keys``:  canonical seed key per window position, position order
  (= (content << 1) | strand_bit; see libmems_tpu.ops.mers)
* ``sorted_keys`` / ``sorted_positions``: the SML proper — (key, position)
  pairs ordered by key then position.

The out-of-core dmSML path (dmSML/dmsort.c) has no device counterpart
here: genomes that exceed one device's memory are handled by the
seed-prefix-range sharding in libmems_tpu.parallel instead (each shard
sorts its key range independently — the same key-range partitioning
idea dmSML used across scratch disks, now across devices).

Persistence mirrors FileSML's header+data layout in spirit (load if the
file exists and the seed matches, else recreate — MatchList::LoadSMLs,
libMems/MatchList.h:261-349) using a defined little-endian numpy layout
rather than the reference's compiler-dependent C struct bytes.
"""

from __future__ import annotations

import os
import warnings
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from libmems_tpu import _jaxconfig  # noqa: F401
from libmems_tpu import seeds as seedlib
from libmems_tpu import trace
from libmems_tpu.ops.mers import canonical_seed_keys, canonical_seed_keys_np, key_dtype
from libmems_tpu.sequence import Genome

_MAGIC = b"SMLT0001"  # libmems_tpu SML file format v1


@jax.jit
def _sort_by_key(keys: jax.Array) -> tuple[jax.Array, jax.Array]:
    positions = jnp.arange(keys.shape[0], dtype=jnp.int32)
    return jax.lax.sort((keys, positions), num_keys=1, is_stable=True)


def _bucket_len(n: int, minimum: int = 1 << 12) -> int:
    """Pad lengths to sqrt(2)-spaced buckets so different genome lengths
    share compile-cache entries (keys beyond the true window count carry
    the all-ones sentinel and slice off after the sort)."""
    b = minimum
    while b < n:
        b = b * 3 // 2
    return b


@dataclass
class SortedMerList:
    """Canonical spaced-seed mer index of one genome (device arrays)."""

    seed: int
    length: int                    # genome length in bases
    keys: jax.Array                # canonical key per window, position order
    sorted_keys: jax.Array
    sorted_positions: jax.Array    # int32, window positions ordered by key
    circular: bool = False
    filename: str = ""
    # bucket-padded position-order keys (sentinel tail): windows beyond
    # n_windows hold the all-ones sentinel and the array length is
    # _bucket_len-stable, so consumers that concatenate per-genome key
    # tables (find_pairwise_mums) reuse one compiled program across
    # genome families instead of recompiling at every exact size
    # (PERF.md rule 27's cousin: EVERY eager concat shape must be
    # bucketed too).  Built by create() for free; lazily derived for
    # loaded/gathered SMLs.
    keys_padded_cache: jax.Array | None = field(
        default=None, repr=False, compare=False)

    def padded_keys(self) -> jax.Array:
        """Position-order keys padded to the stable bucket length with
        the all-ones sentinel (never matches; ops.extend masks it)."""
        if self.keys_padded_cache is None:
            n = self.n_windows
            seed_len = self.seed_length
            b = _bucket_len(n + seed_len - 1) - seed_len + 1
            pad = b - n
            if pad <= 0:
                self.keys_padded_cache = self.keys
            else:
                sent = ~jnp.zeros((pad,), self.keys.dtype)
                self.keys_padded_cache = jnp.concatenate(
                    [self.keys, sent])
        return self.keys_padded_cache

    @property
    def seed_length(self) -> int:
        return seedlib.seed_length(self.seed)

    @property
    def seed_weight(self) -> int:
        return seedlib.seed_weight(self.seed)

    @property
    def n_windows(self) -> int:
        """Number of seed windows (SMLSize): length - seed_length + 1."""
        return int(self.keys.shape[0])

    @staticmethod
    def create(genome_or_codes, seed: int, circular: bool = False,
               filename: str = "", ambig: np.ndarray | None = None
               ) -> "SortedMerList":
        """Build the SML on device (SortedMerList::Create + std::sort
        equivalent, libMems/SortedMerList.cpp:786, FileSML.cpp:344).

        `ambig` (bool[L], defaulting to the Genome's own mask) excludes
        every seed window overlapping an ambiguous base via the all-ones
        sentinel key (maskNNNNN equivalent, libMems/FileSML.h:135)."""
        if isinstance(genome_or_codes, Genome):
            codes = genome_or_codes.codes
            if ambig is None:
                a = genome_or_codes.ambig
                ambig = a if a.any() else None
            filename = filename or genome_or_codes.filename
            circular = circular or genome_or_codes.circular
        else:
            codes = np.asarray(genome_or_codes, dtype=np.uint8)
        if ambig is not None and not np.asarray(ambig).any():
            ambig = None
        if circular:
            # circular sequences wrap seed_length-1 characters
            # (SortedMerList::Create, SortedMerList.cpp:797-800)
            wrap = seedlib.seed_length(seed) - 1
            codes = np.concatenate([codes, codes[:wrap]])
            if ambig is not None:
                ambig = np.concatenate([ambig, ambig[:wrap]])
            length = len(codes) - wrap
        else:
            length = len(codes)
        seed_len = seedlib.seed_length(seed)
        n = max(len(codes) - seed_len + 1, 0)
        # bucket-pad so arbitrary genome lengths reuse compiled programs
        pad_codes = _bucket_len(len(codes))
        codes_p = np.zeros(pad_codes, dtype=np.uint8)
        codes_p[: len(codes)] = codes
        if ambig is not None:
            ambig_p = np.zeros(pad_codes, dtype=bool)
            ambig_p[: len(codes)] = np.asarray(ambig, bool)
            keys_p = canonical_seed_keys(jnp.asarray(codes_p), seed,
                                         jnp.asarray(ambig_p))
        else:
            keys_p = canonical_seed_keys(jnp.asarray(codes_p), seed)
        sentinel = ~jnp.zeros((), keys_p.dtype)
        masked = jnp.where(
            jnp.arange(keys_p.shape[0]) < n, keys_p, sentinel)
        skeys_p, spos_p = _sort_by_key(masked)
        keys = keys_p[:n]
        skeys, spos = skeys_p[:n], spos_p[:n]
        return SortedMerList(seed=seed, length=int(length), keys=keys,
                             sorted_keys=skeys, sorted_positions=spos,
                             circular=circular, filename=filename,
                             keys_padded_cache=masked)

    def unique_mer_count(self) -> int:
        """Number of distinct canonical mer contents
        (SortedMerList::GetUniqueMerCount, SortedMerList.cpp:465-505)."""
        contents = np.asarray(self.sorted_keys) >> 1
        if contents.size == 0:
            return 0
        return int(1 + (contents[1:] != contents[:-1]).sum())

    # -- persistence (FileSML load-or-create semantics) ------------------

    def save(self, path: str | os.PathLike):
        path = os.fspath(path)
        with open(path, "wb") as fh:
            fh.write(_MAGIC)
            header = np.array(
                [self.seed, self.length, int(self.circular),
                 self.n_windows], dtype="<u8")
            fh.write(header.tobytes())
            np.asarray(self.keys).astype("<u8").tofile(fh)
            np.asarray(self.sorted_positions).astype("<i4").tofile(fh)

    @staticmethod
    def load(path: str | os.PathLike, mmap: bool = True
             ) -> "SortedMerList":
        """Load an SML file.  With mmap=True (default) the on-disk key
        and position arrays are memory-mapped (FileSML's
        boost::iostreams::mapped_file_source equivalent,
        libMems/FileSML.h:109-111): host RAM holds only pages actually
        touched, and device upload streams straight from the page
        cache — the RAM-bounded load path for big genomes."""
        path = os.fspath(path)
        with open(path, "rb") as fh:
            magic = fh.read(8)
            if magic != _MAGIC:
                raise ValueError(f"{path}: not a libmems_tpu SML file")
            seed, length, circular, n = np.frombuffer(fh.read(32),
                                                      dtype="<u8")
            n = int(n)
            keys_off = fh.tell()
        spos_off = keys_off + 8 * n
        dt = key_dtype(int(seed))
        if mmap:
            keys64 = np.memmap(path, dtype="<u8", mode="r",
                               offset=keys_off, shape=(n,))
            spos_mm = np.memmap(path, dtype="<i4", mode="r",
                                offset=spos_off, shape=(n,))
            # chunked upload: host RAM holds one chunk at a time; the
            # sorted-key view is a device gather, never a host copy
            chunk = 1 << 22
            keys = jnp.concatenate([
                jnp.asarray(np.asarray(keys64[i:i + chunk], dtype=dt))
                for i in range(0, max(n, 1), chunk)]) if n else \
                jnp.zeros((0,), dt)
            spos = jnp.concatenate([
                jnp.asarray(np.asarray(spos_mm[i:i + chunk]))
                for i in range(0, max(n, 1), chunk)]) if n else \
                jnp.zeros((0,), jnp.int32)
            skeys = keys[spos]
        else:
            with open(path, "rb") as fh:
                fh.seek(keys_off)
                keys64 = np.fromfile(fh, dtype="<u8", count=n)
                spos_np = np.fromfile(fh, dtype="<i4", count=n)
            keys = jnp.asarray(keys64.astype(dt))
            spos = jnp.asarray(spos_np)
            skeys = jnp.asarray(keys64[spos_np].astype(dt))
        return SortedMerList(seed=int(seed), length=int(length), keys=keys,
                             sorted_keys=skeys,
                             sorted_positions=spos,
                             circular=bool(circular), filename=path)

    @staticmethod
    def create_big(genome_or_codes, seed: int, sml_path: str,
                   scratch_dir: str | None = None,
                   mem_limit: int = 256 << 20,
                   circular: bool = False) -> "SortedMerList":
        """Out-of-core build through the native distribution sort
        (FileSML::dmCreate -> dmSML equivalent, FileSML.cpp:278-314):
        for genomes whose (key, pos) table exceeds device/host RAM.
        Falls back to the pure-python split-sort-merge below
        (FileSML::BigCreate/Merge, FileSML.cpp:417-660) when the native
        library cannot be built."""
        from libmems_tpu import native
        if native.available():
            native.create_file_sml(genome_or_codes, seed, sml_path,
                                   scratch_dir=scratch_dir,
                                   mem_limit=mem_limit, circular=circular)
            return SortedMerList.load(sml_path)
        return SortedMerList._big_create_py(
            genome_or_codes, seed, sml_path, scratch_dir=scratch_dir,
            mem_limit=mem_limit, circular=circular)

    @staticmethod
    def _big_create_py(genome_or_codes, seed: int, sml_path: str,
                       scratch_dir: str | None = None,
                       mem_limit: int = 256 << 20,
                       circular: bool = False) -> "SortedMerList":
        """RAM-bounded split-sort-merge SML build (FileSML::BigCreate +
        Merge, libMems/FileSML.cpp:417-660): the genome is processed in
        chunks that fit mem_limit, each chunk's (key, pos) records are
        sorted and spilled to a scratch run file, and the runs are
        k-way-merged into the final sorted-position array.  Host RAM
        holds one chunk plus one merge block per run at any time."""
        import heapq
        import tempfile

        ambig = None
        if isinstance(genome_or_codes, Genome):
            codes = genome_or_codes.codes
            if genome_or_codes.ambig.any():
                ambig = genome_or_codes.ambig
        else:
            codes = np.asarray(genome_or_codes, dtype=np.uint8)
        if circular:
            wrap = seedlib.seed_length(seed) - 1
            codes = np.concatenate([codes, codes[:wrap]])
            if ambig is not None:
                ambig = np.concatenate([ambig, ambig[:wrap]])
            length = len(codes) - wrap
        else:
            length = len(codes)
        seed_len = seedlib.seed_length(seed)
        n = max(len(codes) - seed_len + 1, 0)
        # 12 bytes/record (u8 key + i4 pos); chunk sized to mem_limit/4
        # to leave room for the sort's working copies
        chunk = max(1 << 16, int(mem_limit // (12 * 4)))
        run_paths = []
        tmpdir = tempfile.mkdtemp(dir=scratch_dir)
        try:
            def _chunk_keys(lo, hi):
                # windows starting in [lo, hi) need codes up to
                # hi+seed_len-1
                amb = None if ambig is None else \
                    ambig[lo:hi + seed_len - 1]
                return canonical_seed_keys_np(
                    codes[lo:hi + seed_len - 1], seed, amb).astype("<u8")

            for lo in range(0, n, chunk):
                hi = min(lo + chunk, n)
                part = _chunk_keys(lo, hi)
                pos = np.arange(lo, hi, dtype="<i4")
                order = np.argsort(part, kind="stable")
                rp = os.path.join(tmpdir, f"run{len(run_paths)}.bin")
                with open(rp, "wb") as fh:
                    rec = np.empty(hi - lo,
                                   dtype=[("k", "<u8"), ("p", "<i4")])
                    rec["k"] = part[order]
                    rec["p"] = pos[order]
                    rec.tofile(fh)
                run_paths.append(rp)

            # k-way merge of sorted runs -> sorted positions, streaming
            rec_dt = np.dtype([("k", "<u8"), ("p", "<i4")])
            block = max(1 << 14, chunk // max(len(run_paths), 1))
            readers = [np.memmap(rp, dtype=rec_dt, mode="r")
                       for rp in run_paths]
            heads = [(int(r[0]["k"]), ri, 0) for ri, r in enumerate(readers)
                     if len(r)]
            heapq.heapify(heads)
            spos_parts = []
            out = np.empty(block, dtype="<i4")
            fill = 0
            spos_path = os.path.join(tmpdir, "spos.bin")
            with open(spos_path, "wb") as sfh:
                while heads:
                    k, ri, off = heapq.heappop(heads)
                    out[fill] = readers[ri][off]["p"]
                    fill += 1
                    if fill == block:
                        out[:fill].tofile(sfh)
                        fill = 0
                    if off + 1 < len(readers[ri]):
                        heapq.heappush(
                            heads, (int(readers[ri][off + 1]["k"]), ri,
                                    off + 1))
                if fill:
                    out[:fill].tofile(sfh)

            # write the SML file: header + position-order keys + sorted
            # positions, all streamed in chunks
            with open(sml_path, "wb") as fh:
                fh.write(_MAGIC)
                header = np.array([seed, length, int(circular), n],
                                  dtype="<u8")
                fh.write(header.tobytes())
                for lo in range(0, n, chunk):
                    hi = min(lo + chunk, n)
                    _chunk_keys(lo, hi).tofile(fh)
                spos_mm = np.memmap(spos_path, dtype="<i4", mode="r")
                for lo in range(0, n, chunk):
                    np.asarray(spos_mm[lo:lo + chunk]).tofile(fh)
        finally:
            import shutil
            shutil.rmtree(tmpdir, ignore_errors=True)
        return SortedMerList.load(sml_path)

    @staticmethod
    def create_with_fallback(genome_or_codes, seed: int,
                             sml_path: str | os.PathLike | None = None,
                             circular: bool = False,
                             scratch_dir: str | None = None
                             ) -> "SortedMerList":
        """In-memory device build, falling back to the out-of-core path
        when the device (or host) allocator gives out — the reference's
        RAM-first, dmSML-on-bad_alloc policy (FileSML::Create catching
        bad_alloc -> dmCreate, libMems/FileSML.cpp:316-374)."""
        import tempfile
        try:
            sml = SortedMerList.create(genome_or_codes, seed,
                                       circular=circular)
            if sml_path is not None:
                sml.save(sml_path)
            return sml
        except (MemoryError, Exception) as e:
            msg = str(e)
            oom = isinstance(e, MemoryError) or \
                "RESOURCE_EXHAUSTED" in msg or "Out of memory" in msg \
                or "out of memory" in msg
            if not oom:
                raise
        trace.count("host_fallback/sml_out_of_core")
        warnings.warn("SortedMerList: device allocator exhausted, building "
                      "the index with the out-of-core host sorter",
                      RuntimeWarning, stacklevel=2)
        if sml_path is None:
            tmp = tempfile.NamedTemporaryFile(suffix=".sml", delete=False,
                                              dir=scratch_dir)
            tmp.close()
            sml_path = tmp.name
        return SortedMerList.create_big(genome_or_codes, seed,
                                        os.fspath(sml_path),
                                        scratch_dir=scratch_dir,
                                        circular=circular)

    @staticmethod
    def load_or_create(genome: Genome, seed: int,
                       sml_path: str | os.PathLike | None = None,
                       circular: bool = False) -> "SortedMerList":
        """Load the SML if present with a matching seed, else (re)create —
        MatchList::LoadSMLs semantics (libMems/MatchList.h:261-349,
        seed-mismatch recreate h:297-302).  Creation falls back to the
        out-of-core sorter on allocator exhaustion."""
        if sml_path is not None and os.path.exists(sml_path):
            try:
                sml = SortedMerList.load(sml_path)
                if sml.seed == seed and sml.length == len(genome):
                    return sml
            except (ValueError, OSError):
                pass
        return SortedMerList.create_with_fallback(
            genome, seed, sml_path=sml_path, circular=circular)


def default_seed(genomes: list[Genome], seed_rank: int = 0) -> int:
    """Default seed pattern for a set of genomes
    (MatchList::GetDefaultMerSize, libMems/MatchList.h:351-357)."""
    if not genomes:
        raise ValueError("no genomes")
    avg = sum(len(g) for g in genomes) // len(genomes)
    weight = seedlib.default_seed_weight(avg)
    return seedlib.get_seed(weight, seed_rank)


def create_smls(genomes: list[Genome], seed: int | None = None,
                seed_rank: int = 0) -> tuple[list[SortedMerList], int]:
    """Create in-memory SMLs for all genomes
    (MatchList::CreateMemorySMLs, libMems/MatchList.h:407-435).

    Creates run concurrently on a small thread pool, so one genome's
    host-side key preparation overlaps another's device sort."""
    if seed is None:
        seed = default_seed(genomes, seed_rank)
    if len(genomes) <= 1:
        return [SortedMerList.create(g, seed) for g in genomes], seed
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=min(len(genomes), 8)) as ex:
        smls = list(ex.map(lambda g: SortedMerList.create(g, seed),
                           genomes))
    return smls, seed
