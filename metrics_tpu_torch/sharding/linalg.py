"""Dense linear algebra for FID on the device (counterpart of
``metrics_tpu/sharding/linalg.py``).

The matrix square root is the coupled **Newton–Schulz iteration**: matmuls
only, so the whole FID reduction stays on the card and only the scalar
result reaches the host, with no ``2 d^2`` device-to-host copy and no
single-core host eigendecomposition. On one device the port runs it as a
plain function (40 iterations of ``[d, d]`` matmuls in the covariances'
dtype, float64 for FID's states); sharding the operands over a mesh is the
sharded state plane's work, not yet ported.

Accuracy contract: against the host eigendecomposition path, the
Newton–Schulz FID agrees to ``NEWTON_SCHULZ_FID_RTOL`` (relative, on the
FID value).
"""
from typing import Any, Tuple

import torch

__all__ = ["NEWTON_SCHULZ_FID_RTOL", "covariance_from_sums", "fid_from_moments", "newton_schulz_sqrtm"]

#: Documented agreement bound of the Newton–Schulz FID vs the host
#: eigendecomposition path (relative, on the FID value).
NEWTON_SCHULZ_FID_RTOL = 1e-3


def newton_schulz_sqrtm(mat: torch.Tensor, iters: int = 40, eps: float = 1e-6) -> torch.Tensor:
    """Principal square root of a symmetric PSD matrix via the coupled
    Newton–Schulz iteration.

    The iteration ``Y_{k+1} = Y_k (3I - Z_k Y_k) / 2``,
    ``Z_{k+1} = (3I - Z_k Y_k) Z_k / 2`` converges quadratically to
    ``(sqrt(A/|A|), sqrt(A/|A|)^-1)`` when the normalized spectrum sits in
    ``(0, sqrt(3))``; Frobenius normalization guarantees the upper bound and
    the ``eps``-scaled diagonal shift keeps the smallest eigenvalue away
    from the slow-convergence region at 0. No host sync: the norm's zero
    guard is a ``torch.where``.
    """
    d = mat.shape[-1]
    ident = torch.eye(d, dtype=mat.dtype, device=mat.device)
    # scale the shift with the mean eigenvalue so the regularization is
    # invariant to the overall magnitude of the covariance
    mat = mat + (eps * torch.trace(mat) / d) * ident
    norm = torch.sqrt(torch.sum(mat * mat))
    norm = torch.where(norm > 0, norm, torch.ones_like(norm))
    y = mat / norm
    z = ident
    for _ in range(iters):
        t = 0.5 * (3.0 * ident - z @ y)
        y, z = y @ t, t @ z
    return y * torch.sqrt(norm)


def fid_from_moments(
    mu1: torch.Tensor, cov1: torch.Tensor, mu2: torch.Tensor, cov2: torch.Tensor, iters: int = 40
) -> torch.Tensor:
    """Fréchet distance between two Gaussians from their moments, on their
    device: ``|mu1 - mu2|^2 + Tr(S1 + S2 - 2 sqrt(sqrt(S1) S2 sqrt(S1)))``
    with both square roots by Newton–Schulz. ``sqrt(S1) S2 sqrt(S1)`` is
    similar to ``S1 S2`` (same spectrum) but symmetric PSD, and is
    symmetrized explicitly against matmul round-off before the second root.
    Returns a 0-d tensor; nothing waits for the device."""
    s1_half = newton_schulz_sqrtm(cov1, iters=iters)
    inner = s1_half @ cov2 @ s1_half
    inner = 0.5 * (inner + inner.T)
    covmean = newton_schulz_sqrtm(inner, iters=iters)
    diff = mu1 - mu2
    return diff @ diff + torch.trace(cov1) + torch.trace(cov2) - 2.0 * torch.trace(covmean)


def covariance_from_sums(s: torch.Tensor, outer: torch.Tensor, n: Any) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(mu, cov)`` from streaming sufficient statistics ``(sum x,
    sum x x^T, n)``: the device-side mirror of the host reconstruction in
    ``image/fid.py``. ``n`` may be a device scalar."""
    n = torch.as_tensor(n).to(device=s.device, dtype=s.dtype)
    mu = s / n
    cov = (outer - n * torch.outer(mu, mu)) / (n - 1.0)
    return mu, cov
