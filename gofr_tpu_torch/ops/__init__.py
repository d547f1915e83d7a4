"""Kernels and plain tensor ops of the port (counterpart of gofr_tpu/ops)."""
