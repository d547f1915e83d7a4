"""Introspection of a running App (the port's counterpart of
gofr_tpu/observe/, reduced to the in-flight registry the App's
middleware and graceful stop read)."""

from .registry import InflightRequest, RequestRegistry

__all__ = ["InflightRequest", "RequestRegistry"]
