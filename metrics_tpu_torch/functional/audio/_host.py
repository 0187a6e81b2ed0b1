"""Per-sample host dispatch for the C-backed audio algorithms (counterpart
of ``metrics_tpu/functional/audio/_host.py``): one read of the inputs as
float32 numpy, the leading axes flattened, a loop, and the scores back on
the inputs' device."""
from typing import Callable

import numpy as np
import torch


def _host_per_sample(fn: Callable, preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Apply ``fn(target_1d, preds_1d) -> float`` over every leading index."""
    device = preds.device
    preds_np = preds.detach().cpu().numpy().astype(np.float32)
    target_np = target.detach().cpu().numpy().astype(np.float32)
    if preds_np.ndim == 1:
        return torch.tensor(fn(target_np, preds_np), dtype=torch.float32, device=device)
    flat_p = preds_np.reshape(-1, preds_np.shape[-1])
    flat_t = target_np.reshape(-1, target_np.shape[-1])
    scores = np.array([fn(t, p) for p, t in zip(flat_p, flat_t)], dtype=np.float32)
    return torch.from_numpy(scores.reshape(preds_np.shape[:-1])).to(device)
