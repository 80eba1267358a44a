"""Framework integrations (counterpart of bitblas_tpu/integration)."""
