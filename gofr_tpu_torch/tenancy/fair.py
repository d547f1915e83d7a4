"""Deficit-round-robin line for per-tenant weighted fair scheduling (the
port's own copy of gofr_tpu/tenancy/fair.py).

``WeightedFairLine`` stands in for the plain ``collections.deque`` each
SLO class keeps inside the generator's ``_ClassPending``: the same
``append`` / ``appendleft`` / ``popleft`` / ``__len__`` surface, but
inside one FIFO per tenant, served deficit-round-robin over the
tenant's registry weight. Weights 2:1:1 under saturation pop A, A, B,
C, A, A, B, C, ... A fresh tenant starts with one full quantum, and a
tenant with nothing queued costs nothing: the line is work-conserving,
its unused share flows to whoever waits.

The cost is 1 a request (fairness over admission slots; the decode
token share follows because the loop drains this line). The quantum
of a round is the tenant's weight.

Locking: none here. The single owner (``_ClassPending``) serialises
``put``, ``put_front`` and ``get_nowait`` under its own lock; its
lock-free readers only read ``len``.

``appendleft`` exists for one caller pattern: the loop pops a request,
cannot place it (a lattice admission deferred while blocks are in
flight), and pushes it back to the front. That undo restores the state
before the pop exactly -- the same tenant at the head of the ring with
its deficit before the serve -- or the retry would rotate the ring and
break both fairness and the FIFO order within a tenant. Each pop keeps
a (tenant, deficit) snapshot for that undo.
"""

from __future__ import annotations

from collections import deque

__all__ = ["WeightedFairLine"]

_DEFAULT = "default"


def _tenant_of(req) -> str:
    # requests without a tenant (an engine with no plane, or tests that
    # build them with object.__new__) share the default line, which
    # makes the scheduler plain FIFO
    return getattr(req, "tenant", None) or _DEFAULT


def _weight_of(req) -> int:
    try:
        return max(1, int(getattr(req, "tenant_weight", 1)))
    except (TypeError, ValueError):
        return 1


class WeightedFairLine:
    __slots__ = ("_lines", "_weight", "_deficit", "_order", "_len",
                 "_last")

    def __init__(self):
        self._lines: dict[str, deque] = {}
        self._weight: dict[str, int] = {}
        self._deficit: dict[str, float] = {}
        self._order: deque = deque()   # the tenants with waiters, a ring
        self._len = 0
        self._last: tuple[str, float] | None = None   # the pop's undo

    # -- deque surface -------------------------------------------------------
    def append(self, req) -> None:
        tid = _tenant_of(req)
        self._weight[tid] = _weight_of(req)
        line = self._lines.get(tid)
        if line is None:
            line = self._lines[tid] = deque()
            self._order.append(tid)
            # a fresh arrival starts with one full quantum: servable at
            # once, and the first round already runs at the configured
            # ratio (2:1:1 pops A, A, B, C from the first pop)
            self._deficit[tid] = self._weight[tid]
        line.append(req)
        self._len += 1

    def popleft(self):
        if self._len == 0:
            raise IndexError("pop from an empty WeightedFairLine")
        while True:
            tid = self._order[0]
            line = self._lines.get(tid)
            if not line:
                # a stale head: drop it
                self._order.popleft()
                self._lines.pop(tid, None)
                self._deficit.pop(tid, None)
                continue
            d = self._deficit[tid]
            if d < 1:
                d += self._weight.get(tid, 1)
                if d < 1:
                    self._deficit[tid] = d
                    self._order.rotate(-1)
                    continue
                self._deficit[tid] = d
            self._last = (tid, self._deficit[tid])
            self._deficit[tid] = d = self._deficit[tid] - 1
            req = line.popleft()
            self._len -= 1
            if not line:
                self._order.popleft()
                self._lines.pop(tid, None)
                self._deficit.pop(tid, None)
            elif d < 1:
                self._order.rotate(-1)
            return req

    def appendleft(self, req) -> None:
        """The front-of-line undo of the single consumer's latest
        ``popleft``: restores the request and the scheduler's position,
        so the next ``popleft`` serves it again from the same round."""
        tid = _tenant_of(req)
        line = self._lines.get(tid)
        if line is None:
            line = self._lines[tid] = deque()
            self._deficit[tid] = self._weight.get(tid, 1)
        line.appendleft(req)
        self._len += 1
        self._weight.setdefault(tid, _weight_of(req))
        last = self._last
        if last is not None and last[0] == tid:
            # the exact undo of the matching popleft: the head of the
            # ring, the deficit before the serve
            if self._order and self._order[0] == tid:
                pass
            elif tid in self._order:
                # the pop rotated the tenant to the back: bring it home
                while self._order[0] != tid:
                    self._order.rotate(1)
            else:
                self._order.appendleft(tid)
            self._deficit[tid] = last[1]
            self._last = None
        elif tid not in self._order:
            self._order.appendleft(tid)

    def __len__(self) -> int:
        return self._len

    def __bool__(self) -> bool:
        return self._len > 0

    # -- introspection -------------------------------------------------------
    def by_tenant(self) -> dict[str, int]:
        return {tid: len(line) for tid, line in self._lines.items() if line}
