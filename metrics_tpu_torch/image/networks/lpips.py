"""LPIPS perceptual network (VGG16 / AlexNet backbone + linear heads) in
PyTorch (counterpart of ``metrics_tpu/image/networks/lpips.py``).

The net the reference wraps from the ``lpips`` wheel (Zhang et al.'s
``LPIPS(net=...)``: pretrained torchvision backbones and learned linear
calibration heads). The pipeline is:

1. scale inputs (already in ``[-1, 1]``) by the fixed ScalingLayer shift/scale,
2. run the backbone, tapping the canonical ReLU outputs
   (VGG16: relu1_2/2_2/3_3/4_3/5_3; AlexNet: the five conv ReLUs),
3. unit-normalize each tap over channels (eps 1e-10), take the squared
   difference between the two images' activations,
4. collapse channels with a learned non-negative 1x1 conv ("lin" head),
   average spatially, and sum over taps.

NCHW activations, OIHW kernels; the ``.npz`` weights hold the JAX package's
HWIO layout and are transposed once at load. Both images of a pair go
through the backbone as one batch. Full float32, TF32 off.
"""
import os
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from metrics_tpu_torch.image.networks._common import SharedNetwork, full_fp32
from metrics_tpu_torch.image.networks._common import max_pool as _max_pool
from metrics_tpu_torch.image.networks._common import npz_path as _npz_path
from metrics_tpu_torch.image.networks._common import resolve_device
from metrics_tpu_torch.image.networks._common import to_nchw as _to_nchw

Params = Dict[str, Dict[str, torch.Tensor]]

# fixed input normalization (lpips ScalingLayer constants)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

_VGG16_CONVS: List[Tuple[int, int, int]] = [  # (torchvision idx, cin, cout)
    (0, 3, 64), (2, 64, 64),
    (5, 64, 128), (7, 128, 128),
    (10, 128, 256), (12, 256, 256), (14, 256, 256),
    (17, 256, 512), (19, 512, 512), (21, 512, 512),
    (24, 512, 512), (26, 512, 512), (28, 512, 512),
]
# 2x2 max pool BEFORE these conv positions (torchvision MaxPool indices 4, 9, 16, 23)
_VGG16_POOL_BEFORE = {5, 10, 17, 24}
_VGG16_TAPS = (2, 7, 14, 21, 28)  # ReLU outputs of these convs
_VGG16_CHANNELS = (64, 128, 256, 512, 512)

_ALEX_CONVS: List[Tuple[int, int, int, int, int, int]] = [  # (idx, cin, cout, k, stride, pad)
    (0, 3, 64, 11, 4, 2),
    (3, 64, 192, 5, 1, 2),
    (6, 192, 384, 3, 1, 1),
    (8, 384, 256, 3, 1, 1),
    (10, 256, 256, 3, 1, 1),
]
_ALEX_POOL_BEFORE = {3, 6}  # MaxPool(3, 2) before these convs
_ALEX_TAPS = (0, 3, 6, 8, 10)
_ALEX_CHANNELS = (64, 192, 384, 256, 256)


def _check_net(net: str) -> None:
    if net not in ("vgg", "alex"):
        raise ValueError(f"Argument `net` must be 'vgg' or 'alex', got {net!r}")


def _file_param_spec(net: str) -> Dict[str, Dict[str, Tuple[int, ...]]]:
    """The JAX package's spec (the ``.npz`` layout, HWIO kernels); its order
    is the order of the random draws."""
    _check_net(net)
    spec: Dict[str, Dict[str, Tuple[int, ...]]] = {}
    if net == "vgg":
        for idx, cin, cout in _VGG16_CONVS:
            spec[f"features.{idx}"] = {"kernel": (3, 3, cin, cout), "bias": (cout,)}
        channels = _VGG16_CHANNELS
    else:
        for idx, cin, cout, k, _, _ in _ALEX_CONVS:
            spec[f"features.{idx}"] = {"kernel": (k, k, cin, cout), "bias": (cout,)}
        channels = _ALEX_CHANNELS
    for i, c in enumerate(channels):
        spec[f"lin{i}"] = {"kernel": (c,)}  # non-negative 1x1 conv, no bias
    return spec


def lpips_param_spec(net: str = "vgg") -> Dict[str, Dict[str, Tuple[int, ...]]]:
    """Shape spec in the port's layout (OIHW kernels), keyed by
    torchvision-style conv path + ``lin0..lin4`` heads."""
    return {
        mod: {name: ((s[3], s[2], s[0], s[1]) if len(s) == 4 else s) for name, s in group.items()}
        for mod, group in _file_param_spec(net).items()
    }


def params_from_file_layout(
    tree: Mapping[str, Mapping[str, Any]], net: str, dtype: torch.dtype = torch.float32, device: Any = "cuda"
) -> Params:
    """Parameters in the JAX package's layout (numpy arrays, HWIO kernels)
    as the port's tensors on ``device`` (the card unless the caller names
    another), validated against ``net``."""
    device = resolve_device(device)
    params: Params = {}
    for mod, group in tree.items():
        params[mod] = {}
        for name, v in group.items():
            arr = np.asarray(v)
            if arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            params[mod][name] = torch.from_numpy(np.ascontiguousarray(arr)).to(dtype=dtype, device=device)
    return _validate_params(params, net)


def random_lpips_params(net: str = "vgg", seed: int = 0, dtype: torch.dtype = torch.float32, device: Any = "cuda") -> Params:
    """The same numbers as ``metrics_tpu``'s ``random_lpips_params(net, seed)``,
    drawn in the same order and shapes, laid out for the port on ``device``
    (the card unless the caller names another)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    tree: Dict[str, Dict[str, np.ndarray]] = {}
    for mod, group in _file_param_spec(net).items():
        p: Dict[str, np.ndarray] = {}
        for name, shape in group.items():
            if mod.startswith("lin"):
                arr = rng.uniform(0.0, 1.0, size=shape)  # heads are non-negative
            elif name == "kernel":
                fan_in = int(np.prod(shape[:-1]))
                arr = rng.normal(0.0, 1.0 / np.sqrt(fan_in), size=shape)
            else:
                arr = rng.normal(0.0, 0.1, size=shape)
            p[name] = arr.astype(np.float64 if dtype == torch.float64 else np.float32)
        tree[mod] = p
    return params_from_file_layout(tree, net, dtype, device)


def _conv_relu(p: Dict[str, torch.Tensor], x: torch.Tensor, stride: int = 1, pad: int = 1) -> torch.Tensor:
    return F.relu(F.conv2d(x, p["kernel"], p["bias"], stride=stride, padding=pad))


def _backbone_taps(params: Params, x: torch.Tensor, net: str) -> List[torch.Tensor]:
    _check_net(net)
    taps = []
    if net == "vgg":
        for idx, _, _ in _VGG16_CONVS:
            if idx in _VGG16_POOL_BEFORE:
                x = _max_pool(x, 2, 2)
            x = _conv_relu(params[f"features.{idx}"], x)
            if idx in _VGG16_TAPS:
                taps.append(x)
    else:
        for idx, _, _, _, stride, pad in _ALEX_CONVS:
            if idx in _ALEX_POOL_BEFORE:
                x = _max_pool(x, 3, 2)
            x = _conv_relu(params[f"features.{idx}"], x, stride=stride, pad=pad)
            if idx in _ALEX_TAPS:
                taps.append(x)
    return taps


def _unit_normalize(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    norm = torch.sqrt(torch.sum(x * x, dim=1, keepdim=True))
    return x / (norm + eps)


def lpips_distance(params: Params, img1: torch.Tensor, img2: torch.Tensor, net: str = "vgg") -> torch.Tensor:
    """``[N]`` perceptual distances for NCHW image batches already in ``[-1, 1]``."""
    dtype, device = img1.dtype, img1.device
    shift = torch.tensor(_SHIFT, dtype=dtype).to(device).view(1, 3, 1, 1)
    scale = torch.tensor(_SCALE, dtype=dtype).to(device).view(1, 3, 1, 1)
    return _distance(params, img1, img2, net, shift, scale)


def _distance(params: Params, img1: torch.Tensor, img2: torch.Tensor, net: str, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    n = img1.shape[0]
    x = (torch.cat([img1, img2]) - shift) / scale
    total = None
    with full_fp32():
        for i, f in enumerate(_backbone_taps(params, x, net)):
            diff = (_unit_normalize(f[:n]) - _unit_normalize(f[n:])) ** 2
            w = params[f"lin{i}"]["kernel"].view(1, -1, 1, 1)
            contrib = torch.sum(diff * w, dim=1).mean(dim=(1, 2))  # 1x1 conv + spatial mean
            total = contrib if total is None else total + contrib
    return total


class LPIPSNetwork(SharedNetwork):
    """``(img1, img2) -> [N]`` distance callable, the default for
    ``LearnedPerceptualImagePatchSimilarity``.

    Accepts NCHW (the reference's layout) or NHWC inputs in ``[-1, 1]``; its
    parameters' device and dtype are the network's (inputs are cast to the
    dtype). Shared like ``InceptionV3Features`` (``SharedNetwork``).
    """

    def __init__(self, params: Params, net: str = "vgg"):
        super().__init__()
        _check_net(net)
        self.net = net
        self.params = params
        ref = params["lin0"]["kernel"]
        self._shift = torch.tensor(_SHIFT, dtype=ref.dtype).view(1, 3, 1, 1).to(ref.device)
        self._scale = torch.tensor(_SCALE, dtype=ref.dtype).view(1, 3, 1, 1).to(ref.device)

    def _with_params(self, params: Params) -> "LPIPSNetwork":
        return LPIPSNetwork(params, self.net)

    def forward(self, img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
        x1 = _to_nchw(torch.as_tensor(img1)).to(device=self.device, dtype=self.dtype)
        x2 = _to_nchw(torch.as_tensor(img2)).to(device=self.device, dtype=self.dtype)
        return _distance(self.params, x1, x2, self.net, self._shift, self._scale)

    def extra_repr(self) -> str:
        return f"net={self.net!r}, device={self.device}"


# --------------------------------------------------------------------------
# weights IO
# --------------------------------------------------------------------------
ENV_WEIGHTS_VAR = "METRICS_TPU_LPIPS_WEIGHTS"


def _validate_params(params: Params, net: str) -> Params:
    spec = lpips_param_spec(net)
    missing = sorted(set(spec) - set(params))
    if missing:
        raise ValueError(f"LPIPS '{net}' weights are missing parameter groups: {missing[:5]}")
    unknown = sorted(set(params) - set(spec))
    if unknown:
        raise ValueError(f"LPIPS '{net}' weights contain unknown parameter groups: {unknown[:5]}")
    for mod, group in spec.items():
        for name, shape in group.items():
            if name not in params[mod]:
                raise ValueError(f"LPIPS '{net}' weights are missing {mod}.{name}")
            got = tuple(params[mod][name].shape)
            if got != shape:
                raise ValueError(f"LPIPS weight {mod}.{name} has shape {got}, expected {shape}")
    return params


def load_lpips_weights(path: str, net: str = "vgg", dtype: torch.dtype = torch.float32, device: Any = "cuda") -> Params:
    """Load a local ``.npz`` of either package (keys ``<module>.<param>``,
    HWIO kernels), laid out for the port on ``device`` (the card unless the
    caller names another)."""
    device = resolve_device(device)
    flat = np.load(_npz_path(path))
    tree: Dict[str, Dict[str, np.ndarray]] = {}
    for key in flat.files:
        if "." not in key:
            raise ValueError(
                f"Malformed LPIPS weights file: key {key!r} is not of the form '<module>.<param>'"
            )
        mod, name = key.rsplit(".", 1)
        tree.setdefault(mod, {})[name] = flat[key]
    return params_from_file_layout(tree, net, dtype, device)


def save_lpips_weights(params: Params, path: str) -> None:
    """Write ``params`` in the shared ``.npz`` layout (HWIO kernels)."""
    flat = {}
    for mod, group in params.items():
        for name, v in group.items():
            arr = v.detach().cpu().numpy()
            flat[f"{mod}.{name}"] = arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr
    np.savez(_npz_path(path), **flat)


def convert_torch_lpips_checkpoint(backbone_src: str, lin_src: str, dst: str, net: str = "vgg") -> None:
    """Convert the canonical torch checkpoints to the local ``.npz`` format.

    Args:
        backbone_src: torchvision backbone state dict (``vgg16-397923af.pth`` /
            ``alexnet-owt-*.pth``): keys ``features.<i>.weight/bias``.
        lin_src: lpips-package linear-head state dict (``lpips/weights/v0.1/
            {vgg,alex}.pth``): keys ``lin<i>.model.1.weight`` of shape
            ``[1, C, 1, 1]``.
        dst: output ``.npz`` path for ``load_lpips_weights``.
    """
    spec = lpips_param_spec(net)
    backbone = torch.load(backbone_src, map_location="cpu")
    if hasattr(backbone, "state_dict"):
        backbone = backbone.state_dict()
    flat: Dict[str, np.ndarray] = {}
    for mod in spec:
        if not mod.startswith("features."):
            continue
        w = backbone[f"{mod}.weight"].detach().numpy()  # OIHW
        flat[f"{mod}.kernel"] = w.transpose(2, 3, 1, 0)
        flat[f"{mod}.bias"] = backbone[f"{mod}.bias"].detach().numpy()
    lin = torch.load(lin_src, map_location="cpu")
    if hasattr(lin, "state_dict"):
        lin = lin.state_dict()
    for i in range(5):
        for key in (f"lin{i}.model.1.weight", f"lin.{i}.model.1.weight"):
            if key in lin:
                flat[f"lin{i}.kernel"] = lin[key].detach().numpy().reshape(-1)
                break
        else:
            raise KeyError(f"Could not find lin{i} head in {lin_src}")
    np.savez(_npz_path(dst), **flat)


def resolve_lpips_network(net: str, weights_path: Optional[str], device: Any = "cuda") -> LPIPSNetwork:
    """Build the default perceptual net on ``device`` from a local weights
    file (env-var fallback ``METRICS_TPU_LPIPS_WEIGHTS``)."""
    path = weights_path or os.environ.get(ENV_WEIGHTS_VAR)
    if path is None:
        raise ModuleNotFoundError(
            f"The pretrained '{net}' LPIPS network needs local weights (the port downloads nothing)."
            " Convert the canonical checkpoints once with"
            " `metrics_tpu_torch.image.networks.convert_torch_lpips_checkpoint(backbone, lin, dst)` and"
            f" pass `weights_path=dst` (or set ${ENV_WEIGHTS_VAR}). Alternatively pass"
            " `net=<callable (img1, img2) -> [N] distances>`."
        )
    return LPIPSNetwork(load_lpips_weights(path, net, device=device), net)
