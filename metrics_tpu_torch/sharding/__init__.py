"""The device-side FID linear algebra of the sharded state plane
(counterpart of part of ``metrics_tpu/sharding``): the Newton–Schulz matrix
square root and the Fréchet distance from moments, on one device. The
state-sharding registry (``spec.py``) and the mesh epoch plumbing
(``reduce.py``) are ROADMAP §1 item 7.
"""
from metrics_tpu_torch.sharding.linalg import (  # noqa: F401
    NEWTON_SCHULZ_FID_RTOL,
    covariance_from_sums,
    fid_from_moments,
    newton_schulz_sqrtm,
)

__all__ = ["NEWTON_SCHULZ_FID_RTOL", "covariance_from_sums", "fid_from_moments", "newton_schulz_sqrtm"]
