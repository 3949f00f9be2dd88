"""Canonical spaced-seed mer extraction.

Vectorized equivalent of the reference's rolling-window mer fill +
reverse-complement canonicalization (SortedMerList::FillDnaSeedSML /
GetSeedMer / GetDnaSeedMer / RevCompMer, libMems/SortedMerList.cpp:597-783).

Representation
--------------
The reference packs a mer into the TOP bits of a uint64 and reserves bit 0
as the strand bit (RevCompMer sets ``mer |= 1`` on the reverse complement,
SortedMerList.cpp:613).  We use the order-equivalent RIGHT-aligned key::

    key = (content << 1) | strand_bit

where ``content`` is the seed-weight 2-bit characters packed MSB-first.
``min(fwd_key, rc_key)`` picks the same canonical strand as the reference's
``GetDnaSeedMer`` (forward wins ties on palindromes because its strand bit
is 0), and sorting by ``key`` yields the same order as sorting the
reference's left-aligned bmers.  This equivalence is property-tested
against a bit-exact oracle in tests/oracle/refimpl.py.

Instead of a rolling 64-bit window (a sequential dependence), each of the
seed's `weight` sampled offsets becomes one strided slice of the code
array, and the packed content is a sum of shifted slices — pure vector ops
that XLA fuses into a single pass over HBM.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from libmems_tpu import _jaxconfig  # noqa: F401  (enables x64)
from libmems_tpu import seeds as seedlib


def key_dtype(seed: int) -> jnp.dtype:
    """Smallest unsigned dtype holding (2*weight + 1)-bit canonical keys."""
    w = seedlib.seed_weight(seed)
    return jnp.uint32 if 2 * w + 1 <= 32 else jnp.uint64


def _keys_core(xp, codes, seed: int, slice_fn):
    length = seedlib.seed_length(seed)
    weight = seedlib.seed_weight(seed)
    offsets = seedlib.seed_offsets(seed)
    dt = key_dtype(seed) if xp is jnp else (
        np.uint32 if 2 * weight + 1 <= 32 else np.uint64)
    L = codes.shape[0]
    n = L - length + 1
    if n <= 0:
        return xp.zeros((0,), dtype=dt)
    fwd = xp.zeros((n,), dtype=dt)
    rc = xp.zeros((n,), dtype=dt)
    for j, off in enumerate(offsets):
        ch = slice_fn(codes, off, n).astype(dt)
        # forward: char j is the (weight-1-j)'th 2-bit group from the LSB
        fwd = fwd | (ch << dt(2 * (weight - 1 - j)))
        # reverse complement: complemented char j lands at group j
        rc = rc | ((dt(3) - ch) << dt(2 * j))
    return xp.minimum(fwd << dt(1), (rc << dt(1)) | dt(1))


def _window_bad(xp, ambig, length: int, n: int):
    """bool[n]: window i contains an ambiguous base in [i, i+length)."""
    c = xp.concatenate([xp.zeros((1,), xp.int32),
                        xp.cumsum(ambig.astype(xp.int32))])
    return (c[length:length + n] - c[:n]) > 0


@functools.partial(jax.jit, static_argnums=(1,))
def _canonical_seed_keys_jit(codes: jax.Array, seed: int) -> jax.Array:
    return _keys_core(jnp, codes, seed,
                      lambda c, off, n: jax.lax.slice(c, (off,), (off + n,)))


@functools.partial(jax.jit, static_argnums=(2,))
def _canonical_seed_keys_masked_jit(codes, ambig, seed: int):
    keys = _keys_core(jnp, codes, seed,
                      lambda c, off, n: jax.lax.slice(c, (off,), (off + n,)))
    n = keys.shape[0]
    if n == 0:
        return keys
    bad = _window_bad(jnp, ambig, seedlib.seed_length(seed), n)
    return jnp.where(bad, ~jnp.zeros((), keys.dtype), keys)


def canonical_seed_keys(codes: jax.Array, seed: int,
                        ambig: jax.Array | None = None) -> jax.Array:
    """Canonical seed keys for every window position of one genome.

    Args:
      codes: uint8[L] 2-bit nucleotide codes.
      seed: spaced-seed bitmask (static).
      ambig: optional bool[L]; windows overlapping True positions get the
        all-ones sentinel key (excluded from matching everywhere — the
        maskNNNNN equivalent, libMems/FileSML.h:135).  The sentinel is
        unreachable by real keys: a key has 2*weight+1 bits, strictly
        fewer than its dtype's width.

    Returns:
      keys: unsigned[n] with n = L - seed_length + 1, where
        ``key = (canonical_content << 1) | strand_bit``.
    """
    if ambig is None:
        return _canonical_seed_keys_jit(codes, seed)
    return _canonical_seed_keys_masked_jit(codes, ambig, seed)


def canonical_seed_keys_np(codes: np.ndarray, seed: int,
                           ambig: np.ndarray | None = None) -> np.ndarray:
    """Numpy twin of canonical_seed_keys (host-side/oracle-free paths)."""
    keys = _keys_core(np, codes, seed, lambda c, off, n: c[off:off + n])
    if ambig is not None and keys.shape[0]:
        bad = _window_bad(np, np.asarray(ambig, bool),
                          seedlib.seed_length(seed), keys.shape[0])
        keys = np.where(bad, ~keys.dtype.type(0), keys)
    return keys


def sentinel_content(dtype) -> int:
    """Content field of the masked-window sentinel key (~0 >> 1) —
    unreachable by real seeds, excluded by every enumeration stage."""
    return int(~np.dtype(dtype).type(0) >> np.dtype(dtype).type(1))


def split_key(keys: jax.Array) -> tuple[jax.Array, jax.Array]:
    """(content, strand_bit) from canonical keys."""
    return keys >> 1, (keys & 1).astype(jnp.uint8)
