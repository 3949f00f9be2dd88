"""Segmented-scan helpers over sorted mer tables.

These replace the reference's k-way streaming merge bookkeeping
(MatchFinder::SearchRange, libMems/MatchFinder.cpp:172-340): once the
concatenated (content, genome, position) table is globally sorted, runs of
equal content are contiguous and every per-mer statistic the stream merge
tracked becomes an O(N) vector scan.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def run_starts(*cols: jax.Array) -> jax.Array:
    """bool[N]: True where any key column differs from the previous row."""
    n = cols[0].shape[0]
    flag = jnp.zeros((n,), dtype=bool).at[0].set(True)
    for c in cols:
        flag = flag | jnp.concatenate(
            [jnp.ones((1,), dtype=bool), c[1:] != c[:-1]])
    return flag


def start_index(starts: jax.Array) -> jax.Array:
    """int32[N]: index of the first row of each row's run."""
    idx = jnp.arange(starts.shape[0], dtype=jnp.int32)
    return jax.lax.cummax(jnp.where(starts, idx, 0))


def end_index(starts: jax.Array) -> jax.Array:
    """int32[N]: index one past the last row of each row's run."""
    n = starts.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    ends = jnp.concatenate([starts[1:], jnp.ones((1,), dtype=bool)])
    # nearest end at-or-after each row: reverse cumulative min
    rev = jax.lax.cummin(jnp.where(ends, idx, n)[::-1])[::-1]
    return rev + 1


def run_lengths(starts: jax.Array) -> jax.Array:
    """int32[N]: length of each row's run."""
    return end_index(starts) - start_index(starts)


def seg_cummax(values: jax.Array, seg_starts: jax.Array) -> jax.Array:
    """Inclusive segmented cumulative max of NON-NEGATIVE int values
    (< 2^32).

    Implemented as ONE plain `lax.cummax` over (segment_id << 32 | value):
    segment ids are monotone non-decreasing along the table, so the high
    bits reset the running max at every segment start.  A flag-reset
    `associative_scan` computes the same thing but lowers to a log-depth
    slice/concat network whose compile time was minutes at
    genome-scale N; the packed form compiles like any other cumulative
    op."""
    seg_id = jnp.cumsum(seg_starts.astype(jnp.int64)) - 1
    packed = (seg_id << 32) | values.astype(jnp.int64)
    return (jax.lax.cummax(packed) & 0xFFFFFFFF).astype(values.dtype)


def seg_cumsum(values: jax.Array, seg_starts: jax.Array) -> jax.Array:
    """Inclusive segmented cumulative sum: plain cumsum minus the
    exclusive total at each row's segment start (same compile-time
    rationale as seg_cummax)."""
    cs = jnp.cumsum(values, dtype=values.dtype)
    excl_at_start = (cs - values)[start_index(seg_starts)]
    return cs - excl_at_start


def segment_max_broadcast(values: jax.Array, seg_starts: jax.Array) -> jax.Array:
    """Per-row max of `values` over the row's whole segment."""
    cm = seg_cummax(values, seg_starts)
    return cm[end_index(seg_starts) - 1]


def segment_sum_broadcast(values: jax.Array, seg_starts: jax.Array) -> jax.Array:
    """Per-row sum of `values` over the row's whole segment."""
    cs = seg_cumsum(values, seg_starts)
    return cs[end_index(seg_starts) - 1]
