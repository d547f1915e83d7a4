"""Service health probing + custom-endpoint override (the port's own copy
of gofr_tpu/service/health.py).

Reference: pkg/gofr/service/health.go:18-48 (default GET .well-known/alive ->
Health{UP/DOWN}) and health_config.go:5-23 (HealthConfig decorator
overriding the endpoint).
"""

from __future__ import annotations

from ..datasource import Health, STATUS_DOWN, STATUS_UP
from .wrap import ServiceWrapper

DEFAULT_HEALTH_ENDPOINT = ".well-known/alive"


class CustomHealth(ServiceWrapper):
    def __init__(self, inner, endpoint: str):
        super().__init__(inner)
        self.endpoint = endpoint.lstrip("/")
        self._repoint_breaker_probes()

    def _repoint_breaker_probes(self) -> None:
        """Any CircuitBreaker beneath us must probe the CUSTOM endpoint while
        open (reference health_config.go overrides the endpoint for the whole
        chain). The probe dispatches against the breaker's inner layer so an
        open circuit cannot veto its own recovery check."""
        from .circuit_breaker import CircuitBreaker
        from .wrap import _dispatch

        layer = self.inner
        while layer is not None:
            if isinstance(layer, CircuitBreaker):
                target = layer.inner

                def probe(target=target):
                    from ..datasource import Health, STATUS_DOWN, STATUS_UP

                    try:
                        resp = _dispatch(target, "GET", self.endpoint, None, None, None)
                        status = STATUS_UP if resp.ok else STATUS_DOWN
                        return Health(status=status)
                    except Exception as e:
                        return Health(status=STATUS_DOWN, details={"error": repr(e)})

                layer.health_probe = probe
            layer = getattr(layer, "inner", None)

    def health_check(self) -> Health:
        try:
            resp = self._do("GET", self.endpoint, None, None, None)
            if resp.ok:
                return Health(status=STATUS_UP, details={"host": self.address})
            return Health(status=STATUS_DOWN,
                          details={"host": self.address, "status": resp.status_code})
        except Exception as e:
            return Health(status=STATUS_DOWN,
                          details={"host": self.address, "error": repr(e)})


class HealthOption:
    def __init__(self, endpoint: str):
        self.endpoint = endpoint

    def add_option(self, svc):
        return CustomHealth(svc, self.endpoint)
