"""Framework version constant (the port's own copy of
gofr_tpu/version.py; reference: pkg/gofr/version/version.go:3).
``FRAMEWORK`` names this package."""

__version__ = "0.1.0-dev"
FRAMEWORK = "gofr_tpu_torch"
