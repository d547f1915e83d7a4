"""Serving policies of the port (counterpart of gofr_tpu/resilience.py,
reduced to the decode pipeline's depth policy)."""

from __future__ import annotations


class DecodePipelinePolicy:
    """Depth policy for the generator's decode dispatch pipeline.

    ``depth`` is the configured ceiling (TPU_DECODE_PIPELINE): how many
    fused decode blocks may be in flight on the device stream at once.
    Depth 2 is the steady-state win -- the host reaps block N while
    block N+1 computes, so the device never idles between blocks -- but
    a deeper queue also means anything dispatched NEXT (a latency-class
    admission's prefill, a chunk-lattice slice) waits behind more queued
    compute. ``target()`` is consulted before every pipeline top-up and
    collapses to 1 exactly when that wait would cost an SLO:

      - a latency-class request is waiting for admission (its prefill
        must queue behind at most ONE in-flight block);
      - a chunk-lattice admission was deferred by the in-flight pass
        (the lattice needs a fully reaped loop);
      - speculative decoding is active (verify windows are built from
        host-delivered history, which only exists after a reap).

    Pure and lock-free: callers pass the facts, the policy returns a
    depth."""

    __slots__ = ("depth",)

    def __init__(self, depth: int = 2):
        self.depth = max(1, int(depth))

    def target(self, *, latency_waiting: bool = False,
               lattice_deferred: bool = False,
               spec_decode: bool = False) -> int:
        if latency_waiting or lattice_deferred or spec_decode:
            return 1
        return self.depth
