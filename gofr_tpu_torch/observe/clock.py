"""Fleet clock alignment: NTP-style peer-offset estimation over
timestamps piggybacked on connections the fleet already holds open.

The port's own copy of gofr_tpu/observe/clock.py (the port imports
nothing of the JAX package).

A multi-process serving fleet (gateway + replicas, prefill + decode
pools) emits timelines and wide events stamped with each process's OWN
wall clock. Merging them into one view needs the pairwise clock offset
— and running a real NTP exchange would mean new connections, new
ports, new failure modes. Instead, every round trip the fleet already
makes carries four timestamps:

    t0  client send   (client clock)
    t1  server receive (server clock)
    t2  server send    (server clock)
    t3  client receive (client clock)

the classic NTP sample:

    offset = ((t1 - t0) + (t2 - t3)) / 2     # server_clock - client_clock
    rtt    = (t3 - t0) - (t2 - t1)

The carriers in-tree (no new I/O anywhere):

  - the pd HELLO/HELLO_OK handshake (``pd/protocol.py``) — one sample
    per (re)connect;
  - the pd REQ -> END exchange — one sample per relayed request, so a
    busy P/D pair converges fast;
  - the gateway health poll (``gateway/table.py`` reading
    ``/.well-known/health``, whose body carries the replica's send
    timestamp) — one sample per poll per replica.

Estimation is min-RTT filtered over a bounded window: the sample with
the smallest round trip is the one least contaminated by queueing, and
its ``rtt/2`` bounds the offset error REGARDLESS of path asymmetry
(the error is at most half the round trip, the standard NTP bound).
``uncertainty_s`` adds a small drift allowance for sample age so a
stale estimate honestly widens instead of silently rotting.
"""

from __future__ import annotations

import threading
import time
from collections import deque

__all__ = ["ClockRegistry", "PeerClock"]

#: assumed worst-case relative clock drift between two processes
#: (seconds of divergence per second of sample age). Commodity
#: oscillators drift tens of ppm; 100 ppm is a conservative bound.
DRIFT_PPM = 100.0

#: samples kept per peer (TPU_OBS_CLOCK_WINDOW overrides via the
#: registry constructor)
DEFAULT_WINDOW = 64


class PeerClock:
    """One peer's offset estimate: a bounded window of NTP samples with
    min-RTT selection. ``offset_s`` is PEER minus LOCAL — a peer wall
    timestamp lands on the local axis as ``peer_ts - offset_s``."""

    def __init__(self, name: str, window: int = DEFAULT_WINDOW):
        self.name = name
        self.debug_url: str | None = None  # peer's metrics/debug base URL
        self._lock = threading.Lock()
        # (offset_s, rtt_s, mono_at_sample)
        self._samples: deque[tuple[float, float, float]] = deque(
            maxlen=max(1, int(window)))

    def add_sample(self, t0: float, t1: float, t2: float,
                   t3: float) -> None:
        rtt = (t3 - t0) - (t2 - t1)
        if rtt < 0:
            # a negative round trip means a torn/bogus timestamp set
            # (e.g. a wall-clock step mid-exchange): poison, not data
            return
        offset = ((t1 - t0) + (t2 - t3)) / 2.0
        with self._lock:
            self._samples.append((offset, rtt, time.monotonic()))

    def _best_locked(self) -> tuple[float, float, float] | None:
        if not self._samples:
            return None
        return min(self._samples, key=lambda s: s[1])

    @property
    def aligned(self) -> bool:
        with self._lock:
            return bool(self._samples)

    def offset_s(self) -> float | None:
        with self._lock:
            best = self._best_locked()
        return best[0] if best is not None else None

    def uncertainty_s(self) -> float | None:
        """Honest error bound on ``offset_s``: half the best sample's
        round trip (the NTP asymmetry bound) plus drift for its age."""
        with self._lock:
            best = self._best_locked()
        if best is None:
            return None
        _, rtt, mono = best
        age = max(0.0, time.monotonic() - mono)
        return rtt / 2.0 + age * DRIFT_PPM * 1e-6

    def to_local(self, peer_wall_s: float) -> float | None:
        off = self.offset_s()
        return peer_wall_s - off if off is not None else None

    def stats(self) -> dict:
        with self._lock:
            n = len(self._samples)
            best = self._best_locked()
            newest = self._samples[-1][2] if n else None
        out: dict = {"peer": self.name, "samples": n,
                     "debug_url": self.debug_url}
        if best is not None:
            out["offset_s"] = round(best[0], 9)
            out["rtt_s"] = round(best[1], 9)
            out["uncertainty_s"] = round(self.uncertainty_s() or 0.0, 9)
        if newest is not None:
            out["last_sample_age_s"] = round(
                max(0.0, time.monotonic() - newest), 3)
        return out


class ClockRegistry:
    """The process's view of every peer clock it has sampled. Lives on
    the ``Observe`` bundle; fed by the pd handshake/relay paths and the
    gateway health poller; read by the fleet timeline merge and
    ``/debug/request``."""

    def __init__(self, window: int = DEFAULT_WINDOW):
        self.window = max(1, int(window))
        self._lock = threading.Lock()
        self._peers: dict[str, PeerClock] = {}

    def peer(self, name: str) -> PeerClock:
        with self._lock:
            pc = self._peers.get(name)
            if pc is None:
                pc = self._peers[name] = PeerClock(name,
                                                   window=self.window)
            return pc

    def observe(self, name: str, t0: float, t1: float, t2: float,
                t3: float, debug_url: str | None = None) -> PeerClock:
        """Record one NTP sample for ``name`` (and remember where its
        debug surface lives, when the carrier advertised one)."""
        pc = self.peer(name)
        pc.add_sample(t0, t1, t2, t3)
        if debug_url:
            pc.debug_url = debug_url
        return pc

    def note_peer(self, name: str, debug_url: str | None = None
                  ) -> PeerClock:
        """Register a peer without a sample (explicit ``TPU_OBS_PEERS``
        config): its trace merges unaligned until a carrier samples it."""
        pc = self.peer(name)
        if debug_url:
            pc.debug_url = debug_url
        return pc

    def peers(self) -> dict[str, PeerClock]:
        with self._lock:
            return dict(self._peers)

    def stats(self) -> dict:
        return {name: pc.stats() for name, pc in self.peers().items()}
