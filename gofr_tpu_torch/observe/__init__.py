"""Inference flight recorder and ``/debug`` introspection (the port's
own copy of gofr_tpu/observe/).

The always-on observability layer of the serving stack: an in-flight
request registry, a bounded ring of request lifecycle events, the
serving timeline, the fleet clock registry, a wall-clock sampling
profiler, and the ``/debug`` pages that render them. One ``Observe``
lives on the Container and is handed to the HTTP middleware, the
engines, the gateway and the P/D roles.
"""

from __future__ import annotations

from .clock import ClockRegistry, PeerClock
from .profiler import collect_profile, render_collapsed, sample_once
from .recorder import FlightRecorder
from .registry import InflightRequest, RequestRegistry
from .timeline import Timeline, _enabled_from_env, timeline_from_config

__all__ = [
    "Observe",
    "ClockRegistry",
    "FlightRecorder",
    "InflightRequest",
    "PeerClock",
    "RequestRegistry",
    "Timeline",
    "collect_profile",
    "render_collapsed",
    "sample_once",
    "timeline_from_config",
]


class Observe:
    """The container's observability bundle: the request registry, the
    flight recorder, the serving timeline, the fleet clock registry and
    the tracer the serving stack emits its stage spans through. Always
    built (the recorder and the timeline are bounded rings, the
    registry holds the active requests): observability is not opt-in.

    ``timeline`` defaults to one that honours the ``TPU_TIMELINE``
    process environment, as JAX's does, so an engine built outside a
    Container behaves like the Container's wiring, which passes
    ``timeline_from_config(config)``."""

    def __init__(self, metrics=None, tracer=None, max_events: int = 2048,
                 timeline: "Timeline | None" = None,
                 clock: "ClockRegistry | None" = None):
        self.requests = RequestRegistry()
        self.recorder = FlightRecorder(capacity=max_events)
        self.metrics = metrics
        self.tracer = tracer
        self.clock = clock if clock is not None else ClockRegistry()
        self.timeline = timeline if timeline is not None else Timeline(
            enabled=_enabled_from_env())
