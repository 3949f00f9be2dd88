"""Stage timing, progress reporting, and device profiling hooks.

The reference plumbs progress percentages and wall-clock logs through
ostream pointers (MatchFinder::LogProgress, MatchFinder.cpp:55,300-309;
printProgress, GBE.h:144; AlnProgressTracker, GBE.h:862; SML create
timing, MatchList.h:322-327; printMemUsage, Memory.h; dmSML timing.c).
This module is the structured equivalent:

* ``stage(name)`` — context manager timing one pipeline stage; nested
  stages form a tree; results land in a global registry that
  ``report()`` renders (and callers can read programmatically);
* ``progress(name, done, total)`` — throttled percent logging
  (LogProgress analog);
* ``count(name)`` — event counters (host fallbacks and other route
  changes), recorded whether or not stage timing is enabled;
* ``device_profile(path)`` — wraps ``jax.profiler.trace`` so any stage
  can be captured as an XLA device trace.

Stage timing is disabled by default: enable with ``set_enabled(True)``
or the LIBMEMS_TPU_TRACE=1 environment variable.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from dataclasses import dataclass, field

_enabled = os.environ.get("LIBMEMS_TPU_TRACE", "") == "1"
_mem_enabled = os.environ.get("LIBMEMS_TPU_TRACE_MEM", "") == "1"
_stream = sys.stderr


@dataclass
class StageRecord:
    name: str
    seconds: float = 0.0
    calls: int = 0
    children: dict = field(default_factory=dict)


_root = StageRecord("root")
_stack: list[StageRecord] = [_root]
_last_progress: dict[str, float] = {}
_counters: dict[str, int] = {}


def set_enabled(on: bool, stream=None):
    global _enabled, _stream
    _enabled = on
    if stream is not None:
        _stream = stream


def reset():
    global _root, _stack
    _root = StageRecord("root")
    _stack = [_root]
    _last_progress.clear()
    _counters.clear()


def count(name: str, n: int = 1) -> None:
    """Add n to the event counter `name` (always on: counted events are
    rare route changes, not per-item work)."""
    _counters[name] = _counters.get(name, 0) + n


def counters() -> dict[str, int]:
    return dict(_counters)


@contextlib.contextmanager
def stage(name: str):
    """Time a pipeline stage (SML build, MUM find, GBE, ...)."""
    if not _enabled:
        yield
        return
    parent = _stack[-1]
    rec = parent.children.setdefault(name, StageRecord(name))
    _stack.append(rec)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        rec.seconds += dt
        rec.calls += 1
        _stack.pop()
        print(f"[libmems_tpu] {name}: {dt:.3f}s", file=_stream, flush=True)
        if _mem_enabled:
            print_mem_usage(name)


def progress(name: str, done: int, total: int, min_interval: float = 1.0):
    """Throttled percent progress (MatchFinder::LogProgress analog)."""
    if not _enabled or total <= 0:
        return
    now = time.monotonic()
    last = _last_progress.get(name, 0.0)
    if now - last < min_interval and done < total:
        return
    _last_progress[name] = now
    pct = 100.0 * done / total
    print(f"[libmems_tpu] {name}: {pct:.0f}%", file=_stream, flush=True)


@contextlib.contextmanager
def device_profile(log_dir: str):
    """Capture an XLA device trace for this block (jax.profiler)."""
    import jax
    with jax.profiler.trace(log_dir):
        yield


def stage_seconds(rec: StageRecord | None = None, prefix: str = ""
                  ) -> dict:
    """Flat {stage/path: seconds} view of the collected tree, for
    programmatic reporting (bench_e2e per-stage JSON)."""
    rec = rec or _root
    out = {}
    for child in rec.children.values():
        path = f"{prefix}{child.name}"
        out[path] = round(child.seconds, 3)
        out.update(stage_seconds(child, path + "/"))
    return out


def report(rec: StageRecord | None = None, indent: int = 0) -> str:
    """Render the collected stage tree."""
    rec = rec or _root
    lines = []
    for child in rec.children.values():
        lines.append("  " * indent +
                     f"{child.name}: {child.seconds:.3f}s"
                     f" ({child.calls}x)")
        lines.append(report(child, indent + 1))
    return "\n".join(x for x in lines if x)


def mem_usage_mb() -> float:
    """Resident memory in MB (printMemUsage analog, Memory.h)."""
    try:
        with open("/proc/self/status") as fh:
            for line in fh:
                if line.startswith("VmRSS"):
                    return int(line.split()[1]) / 1024.0
    except OSError:
        pass
    return 0.0


def device_mem_mb() -> float:
    """Live device-array bytes in MB (the HBM side of printMemUsage:
    sum over jax.live_arrays of on-device sizes)."""
    try:
        import jax
        return sum(a.nbytes for a in jax.live_arrays()) / (1 << 20)
    except Exception:
        return 0.0


def print_mem_usage(label: str = "", stream=None):
    """printMemUsage() analog (libMems/Memory.h): one line with host
    RSS and live device-array footprint.  Used by the stage tracer when
    LIBMEMS_TPU_TRACE_MEM=1, and callable directly."""
    out = stream or _stream
    print(f"[libmems_tpu] mem{' ' + label if label else ''}: "
          f"host {mem_usage_mb():.0f} MB, device {device_mem_mb():.0f} MB",
          file=out, flush=True)
