"""InceptionV3 (FID variant) as a PyTorch inference network (counterpart of
``metrics_tpu/image/networks/inception.py``).

The network is the TF1 FID variant of InceptionV3 that the reference takes
from ``torch-fidelity`` (``pt_inception-2015-12-05`` weights). It differs
from the torchvision one in three ways that FID values depend on:

* every in-block average pool excludes the zero padding from its divisor
  (``count_include_pad=False``),
* the last Inception-E block (``Mixed_7c``) uses a **max** pool in its pool
  branch,
* the classifier head has 1008 outputs, and ``logits_unbiased`` is the fc
  matmul without the bias term.

Layout and precision:

* NCHW activations and OIHW kernels (``F.conv2d``'s); the fc kernel is
  ``[out, in]`` (``F.linear``'s). The ``.npz`` weights files hold the JAX
  package's layout (HWIO, fc ``[in, out]``) and are transposed once at load,
  so one file serves both packages.
* Eval-mode BatchNorm (eps 1e-3) is folded to ``x * inv + (bias - mean * inv)``
  with ``inv = scale * rsqrt(var + eps)``, computed once per extractor.
* The forward runs in full float32, TF32 off (``_common.full_fp32``).

The input contract mirrors torch-fidelity: images with values in ``[0, 255]``
(uint8 or float), NCHW or NHWC, resized to 299x299 with TF1-style bilinear
interpolation (``src = dst * in/out``, no half-pixel offset: **not**
``F.interpolate(align_corners=False)``, which has one) and normalized to
``(x - 128) / 128``. The resize is two matmuls with fixed interpolation
matrices.
"""
import os
import threading
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from metrics_tpu_torch.image.networks._common import SharedNetwork, full_fp32
from metrics_tpu_torch.image.networks._common import max_pool as _max_pool
from metrics_tpu_torch.image.networks._common import npz_path as _npz_path
from metrics_tpu_torch.image.networks._common import resolve_device
from metrics_tpu_torch.image.networks._common import to_nchw as _to_nchw

Params = Dict[str, Dict[str, torch.Tensor]]

VALID_FEATURES = (64, 192, 768, 2048)
TAPS = ("64", "192", "768", "2048", "logits_unbiased", "logits")
_BN_EPS = 1e-3


# --------------------------------------------------------------------------
# parameter specification
# --------------------------------------------------------------------------
def _file_param_spec() -> Dict[str, Dict[str, Tuple[int, ...]]]:
    """The JAX package's spec (the ``.npz`` layout): conv kernels HWIO, the fc
    kernel ``[in, out]``. Its order is the order of the random draws."""
    spec: Dict[str, Dict[str, Tuple[int, ...]]] = {}

    def b(name: str, cin: int, cout: int, k: Union[int, Tuple[int, int]]) -> None:
        kh, kw = (k, k) if isinstance(k, int) else k
        spec[name] = {
            "kernel": (kh, kw, cin, cout),
            "scale": (cout,),
            "bias": (cout,),
            "mean": (cout,),
            "var": (cout,),
        }

    b("Conv2d_1a_3x3", 3, 32, 3)
    b("Conv2d_2a_3x3", 32, 32, 3)
    b("Conv2d_2b_3x3", 32, 64, 3)
    b("Conv2d_3b_1x1", 64, 80, 1)
    b("Conv2d_4a_3x3", 80, 192, 3)

    def block_a(name: str, cin: int, pool: int) -> None:
        b(f"{name}.branch1x1", cin, 64, 1)
        b(f"{name}.branch5x5_1", cin, 48, 1)
        b(f"{name}.branch5x5_2", 48, 64, 5)
        b(f"{name}.branch3x3dbl_1", cin, 64, 1)
        b(f"{name}.branch3x3dbl_2", 64, 96, 3)
        b(f"{name}.branch3x3dbl_3", 96, 96, 3)
        b(f"{name}.branch_pool", cin, pool, 1)

    block_a("Mixed_5b", 192, 32)
    block_a("Mixed_5c", 256, 64)
    block_a("Mixed_5d", 288, 64)

    b("Mixed_6a.branch3x3", 288, 384, 3)
    b("Mixed_6a.branch3x3dbl_1", 288, 64, 1)
    b("Mixed_6a.branch3x3dbl_2", 64, 96, 3)
    b("Mixed_6a.branch3x3dbl_3", 96, 96, 3)

    def block_c(name: str, c7: int) -> None:
        b(f"{name}.branch1x1", 768, 192, 1)
        b(f"{name}.branch7x7_1", 768, c7, 1)
        b(f"{name}.branch7x7_2", c7, c7, (1, 7))
        b(f"{name}.branch7x7_3", c7, 192, (7, 1))
        b(f"{name}.branch7x7dbl_1", 768, c7, 1)
        b(f"{name}.branch7x7dbl_2", c7, c7, (7, 1))
        b(f"{name}.branch7x7dbl_3", c7, c7, (1, 7))
        b(f"{name}.branch7x7dbl_4", c7, c7, (7, 1))
        b(f"{name}.branch7x7dbl_5", c7, 192, (1, 7))
        b(f"{name}.branch_pool", 768, 192, 1)

    block_c("Mixed_6b", 128)
    block_c("Mixed_6c", 160)
    block_c("Mixed_6d", 160)
    block_c("Mixed_6e", 192)

    b("Mixed_7a.branch3x3_1", 768, 192, 1)
    b("Mixed_7a.branch3x3_2", 192, 320, 3)
    b("Mixed_7a.branch7x7x3_1", 768, 192, 1)
    b("Mixed_7a.branch7x7x3_2", 192, 192, (1, 7))
    b("Mixed_7a.branch7x7x3_3", 192, 192, (7, 1))
    b("Mixed_7a.branch7x7x3_4", 192, 192, 3)

    def block_e(name: str, cin: int) -> None:
        b(f"{name}.branch1x1", cin, 320, 1)
        b(f"{name}.branch3x3_1", cin, 384, 1)
        b(f"{name}.branch3x3_2a", 384, 384, (1, 3))
        b(f"{name}.branch3x3_2b", 384, 384, (3, 1))
        b(f"{name}.branch3x3dbl_1", cin, 448, 1)
        b(f"{name}.branch3x3dbl_2", 448, 384, 3)
        b(f"{name}.branch3x3dbl_3a", 384, 384, (1, 3))
        b(f"{name}.branch3x3dbl_3b", 384, 384, (3, 1))
        b(f"{name}.branch_pool", cin, 192, 1)

    block_e("Mixed_7b", 1280)
    block_e("Mixed_7c", 2048)

    spec["fc"] = {"kernel": (2048, 1008), "bias": (1008,)}
    return spec


def _to_port_layout(arr: np.ndarray) -> np.ndarray:
    """File layout -> port layout: HWIO -> OIHW, fc ``[in, out]`` -> ``[out, in]``."""
    if arr.ndim == 4:
        return arr.transpose(3, 2, 0, 1)
    if arr.ndim == 2:
        return arr.T
    return arr


def _to_file_layout(arr: np.ndarray) -> np.ndarray:
    if arr.ndim == 4:
        return arr.transpose(2, 3, 1, 0)
    if arr.ndim == 2:
        return arr.T
    return arr


def inception_param_spec() -> Dict[str, Dict[str, Tuple[int, ...]]]:
    """Shape spec of every parameter group in the port's layout, keyed by
    torch-style module path.

    Conv+BN groups carry ``kernel`` (OIHW), ``scale``/``bias``/``mean``/``var``
    (the BN affine + running statistics); ``fc`` carries ``kernel``
    (``[out, in]``) and ``bias``. The JAX package's spec has the same keys
    with HWIO kernels and an ``[in, out]`` fc kernel.
    """
    return {
        mod: {name: tuple(_to_port_layout(np.empty(shape, np.uint8)).shape) for name, shape in group.items()}
        for mod, group in _file_param_spec().items()
    }


def params_from_file_layout(
    tree: Mapping[str, Mapping[str, Any]], dtype: torch.dtype = torch.float32, device: Any = "cuda"
) -> Params:
    """Parameters in the JAX package's layout (numpy arrays: HWIO kernels,
    ``[in, out]`` fc kernel) as the port's tensors on ``device`` (the card
    unless the caller names another), validated."""
    device = resolve_device(device)
    params: Params = {
        mod: {
            name: torch.from_numpy(np.ascontiguousarray(_to_port_layout(np.asarray(v)))).to(dtype=dtype, device=device)
            for name, v in group.items()
        }
        for mod, group in tree.items()
    }
    return _validate_params(params)


def random_inception_params(seed: int = 0, dtype: torch.dtype = torch.float32, device: Any = "cuda") -> Params:
    """Randomly initialized parameters (architecture tests / toy benchmarks):
    the same numbers as ``metrics_tpu``'s ``random_inception_params(seed)``,
    drawn in the same order and shapes, then laid out for the port on
    ``device`` (the card unless the caller names another)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    tree: Dict[str, Dict[str, np.ndarray]] = {}
    for mod, group in _file_param_spec().items():
        p: Dict[str, np.ndarray] = {}
        for name, shape in group.items():
            if name == "kernel":
                fan_in = int(np.prod(shape[:-1]))
                arr = rng.normal(0.0, 1.0 / np.sqrt(fan_in), size=shape)
            elif name == "var":
                arr = rng.uniform(0.5, 1.5, size=shape)
            elif name == "scale":
                arr = rng.uniform(0.5, 1.5, size=shape)
            else:  # bias / mean
                arr = rng.normal(0.0, 0.1, size=shape)
            # the JAX package casts its float64 draws to float32 (or keeps
            # float64): cast the same way before any layout change
            p[name] = arr.astype(np.float64 if dtype == torch.float64 else np.float32)
        tree[mod] = p
    return params_from_file_layout(tree, dtype, device)


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------
def fold_params(params: Params) -> Dict[str, Any]:
    """Each conv group as ``(kernel, inv, shift)`` with the BN folded
    (``inv = scale * rsqrt(var + eps)``, ``shift = bias - mean * inv``), as
    ``[1, C, 1, 1]`` vectors; ``fc`` as ``(kernel, bias)``."""
    folded: Dict[str, Any] = {}
    for mod, p in params.items():
        if mod == "fc":
            folded[mod] = (p["kernel"], p["bias"])
            continue
        inv = p["scale"] * torch.rsqrt(p["var"] + _BN_EPS)
        shift = p["bias"] - p["mean"] * inv
        folded[mod] = (p["kernel"], inv.view(1, -1, 1, 1), shift.view(1, -1, 1, 1))
    return folded


def _bconv(p: Tuple[torch.Tensor, ...], x: torch.Tensor, stride: int = 1, pad: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """Conv (no bias) + eval-mode BatchNorm(eps=1e-3) + ReLU, BN folded to one FMA."""
    kernel, inv, shift = p
    return F.relu(F.conv2d(x, kernel, stride=stride, padding=pad) * inv + shift)


def _avg_pool_excl(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 average pool whose divisor counts only in-bounds taps
    (torch ``count_include_pad=False``): the FID network's defining quirk."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


def _block_a(params: Dict[str, Any], name: str, x: torch.Tensor) -> torch.Tensor:
    p = lambda s: params[f"{name}.{s}"]  # noqa: E731
    b1 = _bconv(p("branch1x1"), x)
    b5 = _bconv(p("branch5x5_2"), _bconv(p("branch5x5_1"), x), pad=(2, 2))
    b3 = _bconv(p("branch3x3dbl_1"), x)
    b3 = _bconv(p("branch3x3dbl_2"), b3, pad=(1, 1))
    b3 = _bconv(p("branch3x3dbl_3"), b3, pad=(1, 1))
    bp = _bconv(p("branch_pool"), _avg_pool_excl(x))
    return torch.cat([b1, b5, b3, bp], dim=1)


def _block_b(params: Dict[str, Any], name: str, x: torch.Tensor) -> torch.Tensor:
    p = lambda s: params[f"{name}.{s}"]  # noqa: E731
    b3 = _bconv(p("branch3x3"), x, stride=2)
    bd = _bconv(p("branch3x3dbl_1"), x)
    bd = _bconv(p("branch3x3dbl_2"), bd, pad=(1, 1))
    bd = _bconv(p("branch3x3dbl_3"), bd, stride=2)
    return torch.cat([b3, bd, _max_pool(x)], dim=1)


def _block_c(params: Dict[str, Any], name: str, x: torch.Tensor) -> torch.Tensor:
    p = lambda s: params[f"{name}.{s}"]  # noqa: E731
    b1 = _bconv(p("branch1x1"), x)
    b7 = _bconv(p("branch7x7_1"), x)
    b7 = _bconv(p("branch7x7_2"), b7, pad=(0, 3))
    b7 = _bconv(p("branch7x7_3"), b7, pad=(3, 0))
    bd = _bconv(p("branch7x7dbl_1"), x)
    bd = _bconv(p("branch7x7dbl_2"), bd, pad=(3, 0))
    bd = _bconv(p("branch7x7dbl_3"), bd, pad=(0, 3))
    bd = _bconv(p("branch7x7dbl_4"), bd, pad=(3, 0))
    bd = _bconv(p("branch7x7dbl_5"), bd, pad=(0, 3))
    bp = _bconv(p("branch_pool"), _avg_pool_excl(x))
    return torch.cat([b1, b7, bd, bp], dim=1)


def _block_d(params: Dict[str, Any], name: str, x: torch.Tensor) -> torch.Tensor:
    p = lambda s: params[f"{name}.{s}"]  # noqa: E731
    b3 = _bconv(p("branch3x3_2"), _bconv(p("branch3x3_1"), x), stride=2)
    b7 = _bconv(p("branch7x7x3_1"), x)
    b7 = _bconv(p("branch7x7x3_2"), b7, pad=(0, 3))
    b7 = _bconv(p("branch7x7x3_3"), b7, pad=(3, 0))
    b7 = _bconv(p("branch7x7x3_4"), b7, stride=2)
    return torch.cat([b3, b7, _max_pool(x)], dim=1)


def _block_e(params: Dict[str, Any], name: str, x: torch.Tensor, pool: str) -> torch.Tensor:
    p = lambda s: params[f"{name}.{s}"]  # noqa: E731
    b1 = _bconv(p("branch1x1"), x)
    b3 = _bconv(p("branch3x3_1"), x)
    b3 = torch.cat([_bconv(p("branch3x3_2a"), b3, pad=(0, 1)), _bconv(p("branch3x3_2b"), b3, pad=(1, 0))], dim=1)
    bd = _bconv(p("branch3x3dbl_1"), x)
    bd = _bconv(p("branch3x3dbl_2"), bd, pad=(1, 1))
    bd = torch.cat([_bconv(p("branch3x3dbl_3a"), bd, pad=(0, 1)), _bconv(p("branch3x3dbl_3b"), bd, pad=(1, 0))], dim=1)
    # Mixed_7c ("E_2") uses a max pool here: the torch-fidelity/TF1 FID quirk
    pooled = _max_pool(x, 3, 1, pad=1) if pool == "max" else _avg_pool_excl(x)
    bp = _bconv(p("branch_pool"), pooled)
    return torch.cat([b1, b3, bd, bp], dim=1)


# --------------------------------------------------------------------------
# preprocessing
# --------------------------------------------------------------------------
_RESIZE_CACHE: Dict[Tuple, torch.Tensor] = {}


def _tf1_linear_matrix(n_in: int, n_out: int, dtype: torch.dtype = torch.float32, device: Any = None) -> torch.Tensor:
    """``[n_out, n_in]`` interpolation matrix of TF1-style bilinear resize
    (``src = dst * in/out``), built in float64 and cast once. Cached per
    device: a CUDA graph capture cannot copy it from the host, so the eager
    warm-up run makes it and the capture reads the cached tensor."""
    key = (n_in, n_out, dtype, str(torch.device(device) if device is not None else "cpu"))
    cached = _RESIZE_CACHE.get(key)
    if cached is not None:
        return cached
    src = np.arange(n_out, dtype=np.float64) * (n_in / n_out)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, n_in - 1)
    frac = src - lo
    m = np.zeros((n_out, n_in), np.float64)
    m[np.arange(n_out), lo] += 1.0 - frac
    m[np.arange(n_out), hi] += frac
    # float32 first, as the JAX package rounds it, then the working dtype
    mat = torch.from_numpy(m.astype(np.float32)).to(dtype=dtype, device=device)
    _RESIZE_CACHE[key] = mat
    return mat


def resize_bilinear_tf1(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """TF1 ``tf.image.resize_bilinear(align_corners=False)`` of an NCHW batch
    as two matmuls (TF32 off). An axis already at its size is left as it is
    (the JAX package multiplies it by an identity, which is exact)."""
    with full_fp32():
        if x.shape[2] != size[0]:
            x = torch.matmul(_tf1_linear_matrix(x.shape[2], size[0], x.dtype, x.device), x)
        if x.shape[3] != size[1]:
            x = torch.matmul(x, _tf1_linear_matrix(x.shape[3], size[1], x.dtype, x.device).T)
    return x


def preprocess_inception_input(
    imgs: torch.Tensor, resize_input: bool = True, dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """uint8/float ``[0, 255]`` NCHW/NHWC -> NCHW 299x299 in ``[-1, 1]``, in
    ``dtype`` (float32 unless a float64 copy of the network asks)."""
    x = _to_nchw(torch.as_tensor(imgs)).to(dtype)
    if resize_input:
        x = resize_bilinear_tf1(x, (299, 299))
    return (x - 128.0) / 128.0


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------
def _forward(folded: Dict[str, Any], x: torch.Tensor, features_list: Sequence[str]) -> Dict[str, torch.Tensor]:
    remaining = set(features_list)
    unknown = remaining - set(TAPS)
    if unknown:
        raise ValueError(f"Unknown inception features requested: {sorted(unknown)}")
    out: Dict[str, torch.Tensor] = {}

    def tap(name: str, value: torch.Tensor) -> bool:
        if name in remaining:
            out[name] = value
            remaining.discard(name)
        return not remaining

    with full_fp32():
        x = _bconv(folded["Conv2d_1a_3x3"], x, stride=2)
        x = _bconv(folded["Conv2d_2a_3x3"], x)
        x = _bconv(folded["Conv2d_2b_3x3"], x, pad=(1, 1))
        x = _max_pool(x)
        if "64" in remaining and tap("64", x.mean(dim=(2, 3))):
            return out

        x = _bconv(folded["Conv2d_3b_1x1"], x)
        x = _bconv(folded["Conv2d_4a_3x3"], x)
        x = _max_pool(x)
        if "192" in remaining and tap("192", x.mean(dim=(2, 3))):
            return out

        x = _block_a(folded, "Mixed_5b", x)
        x = _block_a(folded, "Mixed_5c", x)
        x = _block_a(folded, "Mixed_5d", x)
        x = _block_b(folded, "Mixed_6a", x)
        x = _block_c(folded, "Mixed_6b", x)
        x = _block_c(folded, "Mixed_6c", x)
        x = _block_c(folded, "Mixed_6d", x)
        x = _block_c(folded, "Mixed_6e", x)
        if "768" in remaining and tap("768", x.mean(dim=(2, 3))):
            return out

        x = _block_d(folded, "Mixed_7a", x)
        x = _block_e(folded, "Mixed_7b", x, pool="avg")
        x = _block_e(folded, "Mixed_7c", x, pool="max")
        feats = x.mean(dim=(2, 3))
        if tap("2048", feats):
            return out

        kernel, bias = folded["fc"]
        logits_unbiased = F.linear(feats, kernel)
        tap("logits_unbiased", logits_unbiased)
        tap("logits", logits_unbiased + bias)
    return out


def inception_v3(params: Params, x: torch.Tensor, features_list: Sequence[str] = ("2048",)) -> Dict[str, torch.Tensor]:
    """Run the network on preprocessed NCHW input, tapping the requested features.

    ``features_list`` entries: ``"64"``, ``"192"``, ``"768"`` (globally
    avg-pooled block outputs), ``"2048"`` (final pooled features),
    ``"logits_unbiased"``, ``"logits"``. The forward stops at the deepest
    requested tap, so asking for ``"64"`` runs only the stem.
    """
    return _forward(fold_params(params), x, features_list)


def _extract(params: Params, imgs: torch.Tensor, feature: str, resize_input: bool) -> torch.Tensor:
    """``imgs -> [N, d]`` on the given parameters, the BN folded here: the
    body of a sharded FID encoder, which folds the weights it gathered in
    each dispatch, so no folded copy of the whole weights stays resident."""
    kernel = params["Conv2d_1a_3x3"]["kernel"]
    x = torch.as_tensor(imgs)
    if x.device != kernel.device:
        x = x.to(kernel.device)
    x = preprocess_inception_input(x, resize_input=resize_input, dtype=kernel.dtype)
    return _forward(fold_params(params), x, (feature,))[feature]


def inception_param_specs(axis: str = "mp") -> Dict[str, Dict[str, Any]]:
    """One :class:`~metrics_tpu_torch.sharding.PartitionSpec` per leaf of
    :func:`inception_param_spec`, splitting the network's output channels
    over the mesh axis ``axis``: the layout of
    ``FrechetInceptionDistance(encoder_sharding=axis)``.

    The port's kernels are OIHW and its fc kernel ``[out, in]``, so every
    kernel splits its axis 0 (the JAX package's HWIO kernels split their
    last axis); every BN vector and the fc bias split their only axis.
    All 94 convolutions' output counts and the 1,008 logits divide by 4.
    """
    from metrics_tpu_torch.sharding.spec import PartitionSpec

    return {mod: {name: PartitionSpec(axis) for name in group} for mod, group in inception_param_spec().items()}


class InceptionV3Features(SharedNetwork):
    """``imgs -> [N, d]`` extractor, the default for FID/KID/IS.

    Args:
        params: parameter tree (``load_inception_weights`` /
            ``random_inception_params``); its tensors' device and dtype are
            the extractor's.
        feature: which tap to return (``"2048"``, ``"logits_unbiased"``, ...).
        resize_input: TF1-bilinear-resize inputs to 299x299 first.

    The weights are inference state shared by every metric that holds the
    extractor (``SharedNetwork``: a deep copy is the same object,
    ``on(device)`` a kept copy on another device).
    """

    def __init__(self, params: Params, feature: Union[int, str] = "2048", resize_input: bool = True):
        super().__init__()
        self.feature = str(feature)
        if self.feature not in TAPS:
            raise ValueError(f"Unknown inception features requested: [{self.feature!r}]")
        self.params = params
        self.resize_input = resize_input
        self._folded = fold_params(params)

    @property
    def feature_dim(self) -> int:
        if self.feature in ("logits", "logits_unbiased"):
            return 1008
        return int(self.feature)

    def _with_params(self, params: Params) -> "InceptionV3Features":
        return InceptionV3Features(params, self.feature, self.resize_input)

    def forward(self, imgs: torch.Tensor) -> torch.Tensor:
        x = torch.as_tensor(imgs)
        if x.device != self.device:
            x = x.to(self.device)
        x = preprocess_inception_input(x, resize_input=self.resize_input, dtype=self.dtype)
        return _forward(self._folded, x, (self.feature,))[self.feature]

    def extra_repr(self) -> str:
        return f"feature={self.feature!r}, resize_input={self.resize_input}, device={self.device}"


# --------------------------------------------------------------------------
# weights IO
# --------------------------------------------------------------------------
ENV_WEIGHTS_VAR = "METRICS_TPU_INCEPTION_WEIGHTS"


def _validate_params(params: Params) -> Params:
    spec = inception_param_spec()
    missing = sorted(set(spec) - set(params))
    if missing:
        raise ValueError(f"Inception weights are missing parameter groups: {missing[:5]}...")
    unknown = sorted(set(params) - set(spec))
    if unknown:
        raise ValueError(f"Inception weights contain unknown parameter groups: {unknown[:5]}")
    for mod, group in spec.items():
        for name, shape in group.items():
            if name not in params[mod]:
                raise ValueError(f"Inception weights are missing {mod}.{name}")
            got = tuple(params[mod][name].shape)
            if got != shape:
                raise ValueError(f"Inception weight {mod}.{name} has shape {got}, expected {shape}")
    return params


def load_inception_weights(path: str, dtype: torch.dtype = torch.float32, device: Any = "cuda") -> Params:
    """Load weights from a local ``.npz`` written by ``save_inception_weights``
    or ``convert_torch_inception_checkpoint`` of either package (keys
    ``<module>.<param>``, HWIO kernels), laid out for the port on ``device``
    (the card unless the caller names another)."""
    device = resolve_device(device)
    flat = np.load(_npz_path(path))
    tree: Dict[str, Dict[str, np.ndarray]] = {}
    for key in flat.files:
        if "." not in key:
            raise ValueError(
                f"Malformed Inception weights file: key {key!r} is not of the form '<module>.<param>'"
            )
        mod, name = key.rsplit(".", 1)
        tree.setdefault(mod, {})[name] = flat[key]
    return params_from_file_layout(tree, dtype, device)


def save_inception_weights(params: Params, path: str) -> None:
    """Write ``params`` in the shared ``.npz`` layout (HWIO kernels, fc
    ``[in, out]``), which both packages load."""
    flat = {
        f"{mod}.{name}": _to_file_layout(v.detach().cpu().numpy())
        for mod, group in params.items()
        for name, v in group.items()
    }
    np.savez(_npz_path(path), **flat)


def convert_torch_inception_checkpoint(src: str, dst: str) -> None:
    """Convert the canonical FID checkpoint (``pt_inception-2015-12-05-6726825d.pth``,
    as used by torch-fidelity / pytorch-fid) to the local ``.npz`` format.

    Run once on a host with the checkpoint file; the resulting ``.npz`` is what
    ``FrechetInceptionDistance(feature=2048, weights_path=...)`` loads.
    """
    sd = torch.load(src, map_location="cpu")
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    flat: Dict[str, np.ndarray] = {}
    for key, value in sd.items():
        v = value.detach().cpu().numpy()
        if key == "fc.weight":
            flat["fc.kernel"] = v.T  # [out, in] -> [in, out]
        elif key == "fc.bias":
            flat["fc.bias"] = v
        elif key.endswith(".conv.weight"):
            flat[key[: -len(".conv.weight")] + ".kernel"] = v.transpose(2, 3, 1, 0)  # OIHW -> HWIO
        elif key.endswith(".bn.weight"):
            flat[key[: -len(".bn.weight")] + ".scale"] = v
        elif key.endswith(".bn.bias"):
            flat[key[: -len(".bn.bias")] + ".bias"] = v
        elif key.endswith(".bn.running_mean"):
            flat[key[: -len(".bn.running_mean")] + ".mean"] = v
        elif key.endswith(".bn.running_var"):
            flat[key[: -len(".bn.running_var")] + ".var"] = v
        # num_batches_tracked and aux-classifier (AuxLogits.*) entries are dropped
    np.savez(_npz_path(dst), **flat)


# One extractor per (feature, resolved path, resize_input, device): the
# weights file is read once per process and device, and every metric of one
# configuration shares one extractor (and one encoder program family).
_EXTRACTOR_CACHE: Dict[Tuple, InceptionV3Features] = {}
_EXTRACTOR_LOCK = threading.Lock()


def clear_inception_extractor_cache() -> None:
    """Drop memoized extractors (tests / freeing weight memory)."""
    with _EXTRACTOR_LOCK:
        _EXTRACTOR_CACHE.clear()


def resolve_inception_extractor(
    feature: Union[int, str],
    weights_path: Optional[str],
    resize_input: bool = True,
    device: Any = "cuda",
) -> InceptionV3Features:
    """Build (or reuse) the default extractor from a local weights file on ``device``.

    ``weights_path`` falls back to the ``METRICS_TPU_INCEPTION_WEIGHTS`` env
    var; without either, raise the install-hint-style error the reference
    raises when ``torch-fidelity`` is absent.

    Memoized per ``(feature, resolved path, resize_input, device)``. A
    changed file at the same path keeps serving the cached weights until
    :func:`clear_inception_extractor_cache`.
    """
    if isinstance(feature, int) and feature not in VALID_FEATURES:
        raise ValueError(
            f"Integer input to argument `feature` must be one of {list(VALID_FEATURES)}, but got {feature}"
        )
    path = weights_path or os.environ.get(ENV_WEIGHTS_VAR)
    if path is None:
        raise ModuleNotFoundError(
            "The default InceptionV3 extractor needs local pretrained weights (the port downloads"
            " nothing). Convert the canonical checkpoint once with"
            " `metrics_tpu_torch.image.networks.convert_torch_inception_checkpoint(src, dst)` and pass"
            f" `weights_path=dst` (or set ${ENV_WEIGHTS_VAR}). Alternatively pass"
            " `feature=<callable imgs -> [N, d]>`."
        )
    device = resolve_device(device)
    key = (str(feature), os.path.abspath(os.path.expanduser(path)), bool(resize_input), str(device))
    with _EXTRACTOR_LOCK:
        cached = _EXTRACTOR_CACHE.get(key)
    if cached is not None:
        return cached
    extractor = InceptionV3Features(load_inception_weights(path, device=device), feature, resize_input=resize_input)
    with _EXTRACTOR_LOCK:
        # a racing construction may have won; keep the first so every caller shares one object
        return _EXTRACTOR_CACHE.setdefault(key, extractor)
