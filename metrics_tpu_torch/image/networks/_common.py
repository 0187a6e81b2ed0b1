"""Shared helpers of the inference networks: layout, pooling, weights IO and
full float32 precision (counterpart of ``metrics_tpu/image/networks/_common.py``).

The port works in NCHW with OIHW kernels, the layouts of
``torch.nn.functional.conv2d``; the JAX package works in NHWC with HWIO
kernels. The ``.npz`` files hold the JAX package's layout, so the loaders
transpose once at load.
"""
import os
from contextlib import contextmanager
from typing import Any, Dict, Iterator

import torch
import torch.nn.functional as F
from torch import nn


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    """Accept NCHW (the reference's layout) or NHWC 3-channel batches.

    An ambiguous ``[N, 3, H, 3]`` batch is treated as NCHW, matching the
    layout every reference caller uses.
    """
    if x.ndim != 4:
        raise ValueError(f"Expected 4D image batch, got shape {tuple(x.shape)}")
    if x.shape[1] == 3:
        return x
    if x.shape[-1] == 3:
        return x.permute(0, 3, 1, 2)
    raise ValueError(f"Could not infer channel axis from shape {tuple(x.shape)} (need a 3-channel batch)")


def max_pool(x: torch.Tensor, window: int = 3, stride: int = 2, pad: int = 0) -> torch.Tensor:
    """Max pool whose padding is ``-inf`` (``F.max_pool2d``'s, as the JAX
    ``reduce_window`` with a ``-inf`` init)."""
    return F.max_pool2d(x, window, stride, pad)


def npz_path(path: str) -> str:
    """np.savez appends ``.npz`` to suffix-less paths; normalize so save, load,
    and env-var values agree on the on-disk name."""
    path = os.path.expanduser(path)
    return path if path.endswith(".npz") else path + ".npz"


def resolve_device(device: Any) -> torch.device:
    """The device a network's weights go to: the card unless the caller
    names another (the metrics' rule)."""
    from metrics_tpu_torch.metric import resolve_device as resolve

    return resolve(device)


@contextmanager
def full_fp32() -> Iterator[None]:
    """Run the enclosed convolutions and matmuls in full float32: TF32 off
    for cuDNN (a scoped ``torch.backends.cudnn.flags``) and for cuBLAS (its
    flag set for the block and put back after). TF32 would move 2048-d
    Inception features by about 1e-3 relative, and FID is a difference of
    large traces. Nothing changes outside the block; on the CPU the flags
    have no effect."""
    cudnn = torch.backends.cudnn
    matmul = torch.backends.cuda.matmul
    saved = matmul.allow_tf32
    matmul.allow_tf32 = False
    try:
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark, deterministic=cudnn.deterministic, allow_tf32=False):
            yield
    finally:
        matmul.allow_tf32 = saved


class SharedNetwork(nn.Module):
    """An inference network over a plain parameter dict (``self.params``):
    immutable state that every metric holding it shares. A deep copy
    returns the same object, and :meth:`on` gives (and keeps) a copy on
    another device, which is how an extractor follows its metric;
    ``.to()`` does not move the parameters. Subclasses rebuild themselves
    from moved parameters in :meth:`_with_params`."""

    params: Dict[str, Dict[str, torch.Tensor]]

    def _with_params(self, params: Dict[str, Dict[str, torch.Tensor]]) -> "SharedNetwork":
        raise NotImplementedError

    @property
    def device(self) -> torch.device:
        return next(iter(next(iter(self.params.values())).values())).device

    @property
    def dtype(self) -> torch.dtype:
        return next(iter(next(iter(self.params.values())).values())).dtype

    def on(self, device: Any) -> "SharedNetwork":
        """This network on ``device``: itself when it is there, else a copy
        made once and kept."""
        device = torch.device(device)
        if device.type == self.device.type and (device.index is None or device.index == self.device.index):
            return self
        copies = self.__dict__.setdefault("_copies", {})
        key = str(device)
        if key not in copies:
            copies[key] = self._with_params({m: {n: t.to(device) for n, t in g.items()} for m, g in self.params.items()})
        return copies[key]

    def __deepcopy__(self, memo: Dict) -> "SharedNetwork":
        return self

    def __getstate__(self) -> Dict[str, Any]:
        state = dict(self.__dict__)
        state.pop("_copies", None)
        state.pop("_stream_encoders", None)  # kept by FrechetInceptionDistance; rebuilt on demand
        return state
