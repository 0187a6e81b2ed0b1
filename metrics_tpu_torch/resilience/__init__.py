"""Resilience layers of the port (counterpart of ``metrics_tpu/resilience``):
so far the numerical-health screening, :mod:`~metrics_tpu_torch.resilience.health`."""
