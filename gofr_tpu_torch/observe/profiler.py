"""Wall-clock sampling profiler over ``sys._current_frames()``.

The port's own copy of gofr_tpu/observe/profiler.py (the port imports
nothing of the JAX package).

The Python/TPU-native answer to ``net/http/pprof``: sample every live
thread's stack at a fixed cadence for N seconds and emit collapsed
stacks ("frame;frame;frame count" — the input format of every
flamegraph tool). Wall-clock sampling (not CPU) is deliberate: a
serving stack spends its life blocked in device dispatches, queue
waits, and socket reads, and *where it blocks* is exactly the question
``/debug/pprof/profile`` exists to answer.

Pure stdlib, no signals, no tracing hooks: ``sys._current_frames()``
snapshots every thread under the GIL, so sampling perturbs the server
by only the frame walk itself (microseconds per thread per sample).
"""

from __future__ import annotations

import sys
import threading
import time
from collections import Counter


def _format_frame(frame) -> str:
    code = frame.f_code
    # module-ish path tail keeps frames short but unambiguous
    fname = code.co_filename
    for sep in ("/site-packages/", "/lib/python"):
        if sep in fname:
            fname = fname.split(sep)[-1]
    parts = fname.split("/")
    tail = "/".join(parts[-2:]) if len(parts) > 1 else fname
    return f"{code.co_name} ({tail}:{frame.f_lineno})"


def _collapse(frame) -> str:
    """Root-first collapsed stack for one thread."""
    frames = []
    while frame is not None:
        frames.append(_format_frame(frame))
        frame = frame.f_back
    return ";".join(reversed(frames))


def sample_once(skip_thread_ids: "set[int] | None" = None,
                thread_names: "dict[int, str] | None" = None) -> list[str]:
    """One snapshot: a collapsed stack per live thread, prefixed with
    the thread name so per-thread flamegraphs separate cleanly."""
    skip = skip_thread_ids or set()
    names = thread_names if thread_names is not None else {
        t.ident: t.name for t in threading.enumerate()}
    stacks = []
    for tid, frame in sys._current_frames().items():
        if tid in skip:
            continue
        name = names.get(tid, f"thread-{tid}")
        stacks.append(f"{name};{_collapse(frame)}")
    return stacks


def collect_profile(seconds: float = 1.0, hz: float = 100.0) -> Counter:
    """Sample every thread for ``seconds`` at ``hz``; returns
    collapsed-stack -> sample count. The sampling thread excludes
    itself (its stack is just this loop)."""
    seconds = max(0.0, float(seconds))
    # honor sub-1Hz rates (floor only guards div-by-zero); the duration
    # cap lives at the HTTP layer
    interval = 1.0 / max(1e-3, float(hz))
    counts: Counter = Counter()
    own = threading.get_ident()
    deadline = time.monotonic() + seconds
    while True:
        t0 = time.monotonic()
        if t0 >= deadline:
            break
        names = {t.ident: t.name for t in threading.enumerate()}
        for stack in sample_once({own}, names):
            counts[stack] += 1
        # fixed cadence minus the walk's own time, clamped to the window
        # remainder — a sub-1Hz interval must never sleep past the
        # requested duration (the caller may be holding a profile lock)
        now = time.monotonic()
        time.sleep(max(0.0, min(interval - (now - t0), deadline - now)))
    return counts


def render_collapsed(counts: Counter) -> str:
    """Flamegraph-ready text: one ``stack count`` line, heaviest first."""
    lines = [f"{stack} {n}" for stack, n in counts.most_common()]
    return "\n".join(lines) + ("\n" if lines else "")
