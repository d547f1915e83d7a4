"""Inter-service HTTP client with decorator options (the port's own copy
of gofr_tpu/service/, which imports no JAX).

Reference: pkg/gofr/service/ —
  - ``HTTP`` interface with Get/Post/Put/Patch/Delete ± headers
    (service/new.go:26-64)
  - ``NewHTTPService(addr, logger, metrics, options...)`` building a
    decorator chain inside-out (service/new.go:68-87, options applied at
    new.go:82-84 via Options.addOption, service/options.go:3)
  - circuit breaker (service/circuit_breaker.go), auth decorators
    (basic_auth.go / apikey_auth.go / oauth.go), health override
    (health_config.go)

Decorators here are small wrappers satisfying the same client surface, so
any combination composes: ``new_http_service(addr, log, metrics,
CircuitBreakerOption(...), BasicAuthOption(...), HealthOption(...))``.
"""

from .client import HTTPService, Response, new_http_service, stream_generate
from .circuit_breaker import CircuitBreaker, CircuitBreakerOption, CircuitOpenError
from .reconnect import ReconnectBackoff
from .retry import Retry, RetryOption
from .auth import APIKeyAuthOption, BasicAuthOption, OAuthOption
from .health import DEFAULT_HEALTH_ENDPOINT, HealthOption

__all__ = [
    "HTTPService",
    "Response",
    "new_http_service",
    "stream_generate",
    "CircuitBreaker",
    "CircuitBreakerOption",
    "CircuitOpenError",
    "ReconnectBackoff",
    "Retry",
    "RetryOption",
    "BasicAuthOption",
    "APIKeyAuthOption",
    "OAuthOption",
    "HealthOption",
    "DEFAULT_HEALTH_ENDPOINT",
]
