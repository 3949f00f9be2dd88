"""Reference-faithful oracle for libMems match finding (test infrastructure).

A deliberately slow, structurally faithful Python re-statement of the
reference algorithms, used as the parity target for the device pipeline:

* mer encoding / canonicalization: SortedMerList::GetSeedMer,
  RevCompMer, GetDnaSeedMer (libMems/SortedMerList.cpp:597-769) with the
  exact left-aligned 64-bit layout and strand bit.
* seed enumeration: MatchFinder::SearchRange grouping + MemHash /
  PairwiseMatchFinder::EnumerateMatches tolerance semantics
  (libMems/MatchFinder.cpp:172-340, MemHash.cpp:139-162,
  PairwiseMatchFinder.cpp:37-71).
* ungapped maximal extension: MatchFinder::ExtendMatch's jump/unit/restart
  phases (libMems/MatchFinder.h:218-374), ported loop-for-loop.
* dedup: MemHash::AddHashEntry offset-bucket + containment
  (MemHash.cpp:209-251, MatchHashEntry.cpp:164-204).

Only linear (non-circular) sequences are modeled.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field

import numpy as np

M64 = (1 << 64) - 1
NO_MATCH = 0

_TT = np.zeros(256, dtype=np.uint8)
for _c in "cCbByY":
    _TT[ord(_c)] = 1
for _c in "gGsSkK":
    _TT[ord(_c)] = 2
for _c in "tT":
    _TT[ord(_c)] = 3


def seed_length(seed: int) -> int:
    if seed == 0:
        return 0
    return seed.bit_length() - (seed & -seed).bit_length() + 1


def seed_weight(seed: int) -> int:
    return bin(seed).count("1")


def revcomp_mer(mer_a: int, mer_length: int) -> int:
    """Exact port of SortedMerList::RevCompMer (SortedMerList.cpp:597-614)."""
    mer_b = (~mer_a) & M64
    mer_c = 0
    for _ in range(0, 64, 2):
        mer_c |= mer_b & 3
        mer_b >>= 2
        mer_c = (mer_c << 2) & M64
    mer_c = (mer_c << (64 - 2 * (mer_length + 1))) & M64
    mer_c |= 1
    return mer_c


class OracleSML:
    """Minimal in-memory SML with reference mer semantics (linear seqs)."""

    def __init__(self, seq: str, seed: int):
        self.codes = _TT[np.frombuffer(seq.encode(), dtype=np.uint8)]
        self.seed = seed
        self.seed_len = seed_length(seed)
        self.weight = seed_weight(seed)
        self.length = len(seq)
        # offsets of sampled positions within the window, left to right
        self.offsets = [self.seed_len - 1 - b
                        for b in range(self.seed_len - 1, -1, -1)
                        if (seed >> b) & 1]
        # seed_mask covers the top 2*weight bits (SortedMerList.cpp:819-820)
        self.seed_mask = (M64 << (64 - 2 * self.weight)) & M64
        self.sml_len = max(0, self.length - self.seed_len + 1)
        self._table = None

    def get_seed_mer(self, offset: int) -> int:
        """Left-aligned seed content at window `offset` (GetSeedMer)."""
        content = 0
        for off in self.offsets:
            content = (content << 2) | int(self.codes[offset + off])
        return (content << (64 - 2 * self.weight)) & M64

    def get_dna_seed_mer(self, offset: int) -> int:
        fwd = self.get_seed_mer(offset)
        rc = revcomp_mer(fwd, self.weight)
        return min(fwd, rc)

    def sorted_mers(self) -> list[tuple[int, int]]:
        """(mer, position) sorted by mer — the SML itself."""
        if self._table is None:
            self._table = sorted(
                (self.get_dna_seed_mer(p), p) for p in range(self.sml_len)
            )
        return self._table


@dataclass
class OracleMatch:
    """Signed 1-based starts (0 = absent) + length, like mems::Match."""

    starts: list[int]
    length: int
    extended: bool = False

    def copy(self) -> "OracleMatch":
        return OracleMatch(list(self.starts), self.length, self.extended)

    def multiplicity(self) -> int:
        return sum(1 for s in self.starts if s != NO_MATCH)

    def first_start(self) -> int:
        for i, s in enumerate(self.starts):
            if s != NO_MATCH:
                return i
        return len(self.starts)

    def invert(self):
        self.starts = [-s for s in self.starts]

    def offset(self) -> int:
        """Generalized offset (MatchHashEntry::CalculateOffset)."""
        ref_i = self.first_start()
        ref_start = self.starts[ref_i]
        total = 0
        for i in range(ref_i + 1, len(self.starts)):
            s = self.starts[i]
            if s != NO_MATCH:
                off = s - ref_start
                if s < 0:
                    off -= self.length
                total += off
        return total

    def contains(self, other: "OracleMatch") -> bool:
        """Port of MatchHashEntry::Contains (MatchHashEntry.cpp:164-204)."""
        if len(self.starts) != len(other.starts):
            return False
        if self.offset() != other.offset():
            return False
        i = other.first_start()
        if i >= len(self.starts) or self.starts[i] == NO_MATCH:
            return False
        diff = other.starts[i] - self.starts[i]
        if diff < 0 or self.length < other.length + diff:
            return False
        diff_rc = other.length - self.length + diff
        for i in range(i + 1, len(other.starts)):
            di = other.starts[i] - self.starts[i]
            if other.starts[i] == NO_MATCH and self.starts[i] == NO_MATCH:
                continue
            elif other.starts[i] < 0 and di == diff_rc:
                continue
            elif diff != di:
                return False
        return True

    def key(self):
        return (tuple(self.starts), self.length)


def set_direction(match: OracleMatch, smls: list[OracleSML]):
    """Port of MemHash::SetDirection (MemHash.cpp:189-203)."""
    ref_forward = None
    for i, s in enumerate(match.starts):
        if s != NO_MATCH:
            ref_forward = not (smls[i].get_dna_seed_mer(s - 1) & 1)
            first = i
            break
    for i in range(first + 1, len(match.starts)):
        s = match.starts[i]
        if s != NO_MATCH:
            if ref_forward == bool(smls[i].get_dna_seed_mer(s - 1) & 1):
                match.starts[i] = -s


def extend_match(mhe: OracleMatch, smls: list[OracleSML]):
    """Port of MatchFinder::ExtendMatch (MatchFinder.h:218-374), linear seqs."""
    seed_len = smls[0].seed_len
    mer_mask = smls[0].seed_mask
    cur_seqs = [i for i, s in enumerate(mhe.starts) if s != NO_MATCH]
    used = len(cur_seqs)
    jump_size = seed_len
    extend_again = False

    direction = 0
    while direction < 4:
        # maximum traversal before hitting a sequence boundary
        maxlen = 1 << 62
        if direction >= 2:
            maxlen = seed_len
        for i in cur_seqs:
            if mhe.starts[i] < 0:
                rc_len = smls[i].length - mhe.length + mhe.starts[i] + 1
                maxlen = min(maxlen, rc_len)
            else:
                maxlen = min(maxlen, mhe.starts[i] - 1)

        extend_limit = 0
        extend_attempts = 0
        last_mismatch = False  # "i < used_seqs" state of the final step
        while maxlen - jump_size >= 0:
            mhe.length += jump_size
            maxlen -= jump_size
            for i in cur_seqs:
                if mhe.starts[i] > 0:
                    mhe.starts[i] -= jump_size
            # compare canonical mers + parity across all member genomes
            ref = cur_seqs[0]
            mer_to_get = mhe.starts[ref]
            if mer_to_get < 0:
                mer_to_get = -mer_to_get + mhe.length - seed_len
            cur_mer = smls[ref].get_dna_seed_mer(mer_to_get - 1)
            parity = bool(cur_mer & 1) if mhe.starts[ref] < 0 else not (cur_mer & 1)
            cur_mer &= mer_mask
            ok = True
            for i in cur_seqs[1:]:
                mer_to_get = mhe.starts[i]
                if mer_to_get < 0:
                    mer_to_get = -mer_to_get + mhe.length - seed_len
                comp_mer = smls[i].get_dna_seed_mer(mer_to_get - 1)
                comp_parity = (bool(comp_mer & 1) if mhe.starts[i] < 0
                               else not (comp_mer & 1))
                comp_mer &= mer_mask
                if cur_mer != comp_mer or parity != comp_parity:
                    if direction < 2:
                        maxlen = 0
                    ok = False
                    break
            extend_attempts += jump_size
            last_mismatch = not ok
            if ok:
                extend_limit = extend_attempts
            if direction > 1 and extend_attempts == seed_len:
                break

        # cleanup after the loop: revert only the final step if it mismatched
        # (MatchFinder.h "this stuff cleans up if there was a mismatch")
        if last_mismatch:
            mhe.length -= jump_size
            for i in cur_seqs:
                if mhe.starts[i] > 0:
                    mhe.starts[i] += jump_size

        if direction > 1 and extend_attempts > 0:
            if extend_limit > 0:
                extend_again = True
            unmatched_diff = extend_attempts - extend_limit
            if last_mismatch:
                unmatched_diff -= jump_size
            mhe.length -= unmatched_diff
            for i in cur_seqs:
                if mhe.starts[i] > 0:
                    mhe.starts[i] += unmatched_diff

        mhe.invert()
        if direction >= 1:
            jump_size = 1
        if direction == 3 and extend_again:
            direction = 0
            jump_size = seed_len
            extend_again = False
        else:
            direction += 1
    mhe.extended = True


class OracleMemHash:
    """Port of MemHash bucket semantics (MemHash.cpp)."""

    def __init__(self, smls: list[OracleSML], repeat_tolerance: int = 0,
                 enumeration_tolerance: int = 1):
        self.smls = smls
        self.repeat_tolerance = repeat_tolerance
        self.enumeration_tolerance = enumeration_tolerance
        self.buckets: dict[int, list[OracleMatch]] = {}

    def add_entry(self, mhe: OracleMatch):
        bucket = self.buckets.setdefault(mhe.offset(), [])
        for existing in bucket:
            if existing.contains(mhe) or mhe.contains(existing):
                return existing
        if not mhe.extended:
            extend_match(mhe, self.smls)
        stored = mhe.copy()
        # re-probe after extension (AddHashEntry re-runs lower_bound)
        bucket2 = self.buckets.setdefault(stored.offset(), [])
        for existing in bucket2:
            if existing.contains(stored) or stored.contains(existing):
                return existing
        bucket2.append(stored)
        return stored

    def hash_match(self, occ: list[tuple[int, int]]):
        """occ: (genome_id, sml_position) pairs of one seed combination."""
        mhe = OracleMatch([NO_MATCH] * len(self.smls), self.smls[0].seed_len)
        for gid, pos in occ:
            mhe.starts[gid] = pos + 1
        set_direction(mhe, self.smls)
        if mhe.multiplicity() >= 2:
            self.add_entry(mhe)

    def enumerate(self, occ: list[tuple[int, int]]):
        """MemHash::EnumerateMatches tolerance logic (MemHash.cpp:139-162)."""
        tally = [0] * len(self.smls)
        kept = []
        for gid, pos in occ:
            if tally[gid] < self.enumeration_tolerance:
                kept.append((gid, pos))
            if tally[gid] > self.repeat_tolerance:
                return
            tally[gid] += 1
        if len(kept) > 1:
            if self.enumeration_tolerance == 1:
                self.hash_match(kept)
            else:
                # MatchFinder::EnumerateMatches combinatorial expansion
                bygid: dict[int, list] = {}
                for g, p in kept:
                    bygid.setdefault(g, []).append((g, p))
                for combo in itertools.product(*bygid.values()):
                    self.hash_match(list(combo))

    def matches(self) -> list[OracleMatch]:
        out = []
        for b in self.buckets.values():
            out.extend(b)
        return out


class OraclePairwiseFinder(OracleMemHash):
    """Port of PairwiseMatchFinder::EnumerateMatches (PairwiseMatchFinder.cpp:37-71)."""

    def enumerate(self, occ: list[tuple[int, int]]):
        counts: dict[int, int] = {}
        for gid, _ in occ:
            counts[gid] = counts.get(gid, 0) + 1
        unique = [(g, p) for g, p in occ if counts[g] == 1]
        for a in range(len(unique)):
            for b in range(a + 1, len(unique)):
                self.hash_match([unique[a], unique[b]])


def _run_finder(finder: OracleMemHash, smls: list[OracleSML]):
    """K-way merge equivalent: group occurrences by mer content."""
    groups: dict[int, list[tuple[int, int]]] = {}
    mask = smls[0].seed_mask
    for gid, sml in enumerate(smls):
        for mer, pos in sml.sorted_mers():
            groups.setdefault(mer & mask, []).append((mer, gid, pos))
    for content in sorted(groups):
        occ = groups[content]
        # SearchRange consumes genome streams in sorted cursor order; with
        # occurrences per genome contiguous, the effective order is by
        # (genome arrival). Sort by (gid, mer, pos) for determinism: the
        # MemHash tolerances make output order-independent.
        occ.sort(key=lambda t: (t[1], t[0], t[2]))
        if len(occ) > 1:
            finder.enumerate([(g, p) for (_, g, p) in occ])
    return finder.matches()


def find_mums_oracle(seqs: list[str], seed: int, repeat_tolerance: int = 0,
                     enumeration_tolerance: int = 1) -> list[OracleMatch]:
    smls = [OracleSML(s, seed) for s in seqs]
    return _run_finder(
        OracleMemHash(smls, repeat_tolerance, enumeration_tolerance), smls)


def find_pairwise_oracle(seqs: list[str], seed: int) -> list[OracleMatch]:
    smls = [OracleSML(s, seed) for s in seqs]
    return _run_finder(OraclePairwiseFinder(smls), smls)


def match_set(matches: list[OracleMatch]) -> set:
    return {m.key() for m in matches}
