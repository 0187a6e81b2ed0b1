"""Input validation: the shape check shared by the regression metrics, the
checks and normalization of classification inputs, and the retrieval
checks, the one-hot ``[C, -1]`` layout and the recursive ``allclose`` of the
test helpers (counterpart of ``metrics_tpu/utils/checks.py``).

The value checks (negative labels, labels beyond ``num_classes``, non-binary
targets) read concrete values, so each is one ``.item()`` host sync per
update in eager PyTorch. They are the eager error contract. Inside an engine
program (:func:`~metrics_tpu_torch.utils.data.in_program`) they skip, as the
JAX ones skip under tracing: the decisions then rest on shapes, dtypes and
the arguments alone, so the formatting is a fixed program.
"""
from typing import Any, Optional, Tuple

import numpy as np
import torch

from metrics_tpu_torch.obs import trace as _trace
from metrics_tpu_torch.utils.data import in_program, select_topk, to_onehot
from metrics_tpu_torch.utils.enums import DataType
from metrics_tpu_torch.utils.exceptions import JitIncompatibleError


def _check_same_shape(preds: torch.Tensor, target: torch.Tensor) -> None:
    """Raise unless ``preds`` and ``target`` have exactly the same shape."""
    if preds.shape != target.shape:
        raise RuntimeError(
            f"`preds` and `target` shapes must match exactly; received "
            f"preds{tuple(preds.shape)} vs target{tuple(target.shape)}."
        )


def _basic_input_validation(
    preds: torch.Tensor, target: torch.Tensor, threshold: float, multiclass: Optional[bool]
) -> None:
    if target.is_floating_point():
        raise ValueError("`target` carries class labels and must therefore use an integer dtype, not floating point.")
    preds_float = preds.is_floating_point()
    if preds.shape[:1] != target.shape[:1]:
        raise ValueError("`preds` and `target` disagree on the batch (first) dimension.")
    if in_program():
        return  # value checks need concrete values
    if target.min().item() < 0:
        raise ValueError("Negative values found in `target`; class labels must be >= 0.")
    if not preds_float and preds.min().item() < 0:
        raise ValueError("Integer `preds` encode class labels and must be >= 0; negative entries found.")
    if multiclass is False and target.max().item() > 1:
        raise ValueError("`multiclass=False` promises binary-style labels, yet `target` contains values above 1.")
    if multiclass is False and not preds_float and preds.max().item() > 1:
        raise ValueError("`multiclass=False` with integer `preds` requires every prediction to be 0 or 1.")


def _check_shape_and_type_consistency(preds: torch.Tensor, target: torch.Tensor) -> Tuple[DataType, int]:
    """Infer the input case from shapes and dtypes."""
    preds_float = preds.is_floating_point()

    if preds.ndim == target.ndim:
        if preds.shape != target.shape:
            raise ValueError(
                "When `preds` and `target` have equal rank their shapes must match; "
                f"received preds{tuple(preds.shape)} vs target{tuple(target.shape)}."
            )
        if preds_float and not in_program() and target.max().item() > 1:
            raise ValueError(
                "Float `preds` with an equal-shaped `target` means probability inputs, so `target` may only hold 0s and 1s."
            )
        if preds.ndim == 1 and preds_float:
            case = DataType.BINARY
        elif preds.ndim == 1 and not preds_float:
            case = DataType.MULTICLASS
        elif preds.ndim > 1 and preds_float:
            case = DataType.MULTILABEL
        else:
            case = DataType.MULTIDIM_MULTICLASS
        implied_classes = preds[0].numel() if preds.ndim > 1 else 1
    elif preds.ndim == target.ndim + 1:
        if not preds_float:
            raise ValueError(
                "`preds` with an extra dimension relative to `target` are read as per-class scores and must be floating point."
            )
        if preds.shape[2:] != target.shape[1:]:
            raise ValueError(
                "Per-class `preds` must be laid out (N, C, ...) against a (N, ...) `target`; "
                "trailing dimensions do not line up."
            )
        implied_classes = preds.shape[1]
        case = DataType.MULTICLASS if preds.ndim == 2 else DataType.MULTIDIM_MULTICLASS
    else:
        raise ValueError(
            "Unrecognized input layout: supported forms are matching (N, ...) arrays, "
            "or (N, C, ...) scores in `preds` against (N, ...) labels in `target`."
        )
    return case, implied_classes


def _check_num_classes_binary(num_classes: int, multiclass: Optional[bool]) -> None:
    if num_classes > 2:
        raise ValueError("Inputs were detected as binary, which is incompatible with `num_classes` > 2.")
    if num_classes == 2 and not multiclass:
        raise ValueError(
            "Binary inputs with `num_classes=2` only make sense when `multiclass=True` "
            "(i.e. you want the 2-class one-hot expansion)."
        )
    if num_classes == 1 and multiclass:
        raise ValueError(
            "`multiclass=True` asks for the 2-class expansion of binary data, but `num_classes=1` "
            "forbids it. Drop `multiclass` (leave it None) or raise `num_classes` to 2."
        )


def _check_num_classes_mc(
    preds: torch.Tensor, target: torch.Tensor, num_classes: int, multiclass: Optional[bool], implied_classes: int
) -> None:
    if num_classes == 1 and multiclass is not False:
        raise ValueError(
            "`num_classes=1` cannot describe integer label predictions. To fold 2-class "
            "(multi-dim) multi-class inputs down to binary/multi-label, pass `multiclass=False` instead."
        )
    if num_classes > 1:
        if multiclass is False and implied_classes != num_classes:
            raise ValueError(
                "With `multiclass=False` the class count implied by the input shapes must equal "
                "`num_classes`, and here it does not."
            )
        if not in_program() and num_classes <= target.max().item():
            raise ValueError("`target` contains a label outside the valid range [0, num_classes).")
        if preds.shape != target.shape and num_classes != implied_classes:
            raise ValueError("`preds` has a class dimension of different size than `num_classes`.")


def _check_num_classes_ml(num_classes: int, multiclass: Optional[bool], implied_classes: int) -> None:
    if multiclass and num_classes != 2:
        raise ValueError(
            "Multi-label inputs with `multiclass=True` describe a 2-class multi-dim multi-class "
            "conversion, so `num_classes` must be 2 (or left as None)."
        )
    if not multiclass and num_classes != implied_classes:
        raise ValueError("`num_classes` disagrees with the label count implied by the multi-label input shapes.")


def _check_top_k(top_k: int, case: DataType, implied_classes: int, multiclass: Optional[bool], preds_float: bool) -> None:
    if case == DataType.BINARY:
        raise ValueError("`top_k` is meaningless for binary inputs and must not be set.")
    if not isinstance(top_k, int) or top_k <= 0:
        raise ValueError("`top_k` must be a positive integer.")
    if not preds_float:
        raise ValueError("`top_k` selection requires probability/logit `preds`; integer label predictions cannot be ranked.")
    if multiclass is False:
        raise ValueError("`top_k` cannot be combined with `multiclass=False`.")
    if case == DataType.MULTILABEL and multiclass:
        raise ValueError("`top_k` is unsupported for multi-label inputs being expanded via `multiclass=True`.")
    if top_k >= implied_classes:
        raise ValueError("`top_k` must be strictly less than the number of classes in `preds`.")


def _check_classification_inputs(
    preds: torch.Tensor,
    target: torch.Tensor,
    threshold: float,
    num_classes: Optional[int],
    multiclass: Optional[bool],
    top_k: Optional[int],
) -> DataType:
    """Full input validation; returns the input case."""
    _basic_input_validation(preds, target, threshold, multiclass)
    case, implied_classes = _check_shape_and_type_consistency(preds, target)

    if preds.shape != target.shape:
        if multiclass is False and implied_classes != 2:
            raise ValueError(
                "`multiclass=False` requires a 2-wide class dimension in `preds`, "
                "but the inputs carry more than 2 classes."
            )
        if not in_program() and target.max().item() >= implied_classes:
            raise ValueError("`target` references a class index beyond the class dimension of `preds`.")

    if num_classes:
        if case == DataType.BINARY:
            _check_num_classes_binary(num_classes, multiclass)
        elif case in (DataType.MULTICLASS, DataType.MULTIDIM_MULTICLASS):
            _check_num_classes_mc(preds, target, num_classes, multiclass, implied_classes)
        elif case == DataType.MULTILABEL:
            _check_num_classes_ml(num_classes, multiclass, implied_classes)

    if top_k is not None:
        _check_top_k(top_k, case, implied_classes, multiclass, preds.is_floating_point())

    return case


def _input_squeeze(preds: torch.Tensor, target: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Remove size-1 dims except the batch dim."""
    if preds.shape[0] == 1:
        return preds.squeeze().unsqueeze(0), target.squeeze().unsqueeze(0)
    return preds.squeeze(), target.squeeze()


def _input_format_classification(
    preds: torch.Tensor,
    target: torch.Tensor,
    threshold: float = 0.5,
    top_k: Optional[int] = None,
    num_classes: Optional[int] = None,
    multiclass: Optional[bool] = None,
) -> Tuple[torch.Tensor, torch.Tensor, DataType]:
    """Normalize any accepted classification input to binary int32 ``(N, C)``
    or ``(N, C, X)`` tensors, and return the input case. Inside an engine
    program it opens with the device mark ``format`` and closes with
    ``update`` (``obs/trace.py``)."""
    _trace.mark("format", preds)
    preds, target = _input_squeeze(preds, target)
    if preds.dtype == torch.float16:
        preds = preds.float()

    case = _check_classification_inputs(
        preds, target, threshold=threshold, num_classes=num_classes, multiclass=multiclass, top_k=top_k
    )

    if case in (DataType.BINARY, DataType.MULTILABEL) and not top_k:
        preds = (preds >= threshold).to(torch.int32)
        num_classes = num_classes if not multiclass else 2

    if case == DataType.MULTILABEL and top_k:
        preds = select_topk(preds, top_k)

    if case in (DataType.MULTICLASS, DataType.MULTIDIM_MULTICLASS) or multiclass:
        if preds.is_floating_point():
            num_classes = preds.shape[1]
            preds = select_topk(preds, top_k or 1)
        else:
            if num_classes is None:
                if in_program():
                    raise JitIncompatibleError(
                        "Cannot infer `num_classes` from label values inside an update program;"
                        " pass `num_classes` explicitly."
                    )
                num_classes = max(int(preds.max().item()), int(target.max().item())) + 1
            preds = to_onehot(preds, max(2, num_classes))
        target = to_onehot(target, max(2, int(num_classes)))
        if multiclass is False:
            preds, target = preds[:, 1, ...], target[:, 1, ...]

    if (case in (DataType.MULTICLASS, DataType.MULTIDIM_MULTICLASS) and multiclass is not False) or multiclass:
        target = target.reshape(target.shape[0], target.shape[1], -1)
        preds = preds.reshape(preds.shape[0], preds.shape[1], -1)
    else:
        target = target.reshape(target.shape[0], -1)
        preds = preds.reshape(preds.shape[0], -1)

    if preds.ndim > 2 and preds.shape[-1] == 1:
        preds, target = preds.squeeze(-1), target.squeeze(-1)

    preds, target = preds.to(torch.int32), target.to(torch.int32)
    _trace.mark("update", preds)
    return preds, target, case


def _input_format_classification_one_hot(
    num_classes: int,
    preds: torch.Tensor,
    target: torch.Tensor,
    threshold: float = 0.5,
    multilabel: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-hot ``[C, -1]`` layout of classification inputs: class scores
    are argmaxed, integer labels one-hot encoded (unless ``multilabel``),
    float preds of the target's rank thresholded."""
    if preds.ndim not in (target.ndim, target.ndim + 1):
        raise ValueError(
            "one-hot formatting accepts equal-rank preds/target, or preds with exactly one extra (class) dimension"
        )
    if preds.ndim == target.ndim + 1:
        preds = preds.argmax(dim=1)
    if preds.ndim == target.ndim and _is_integer(preds) and num_classes > 1 and not multilabel:
        preds = to_onehot(preds, num_classes=num_classes)
        target = to_onehot(target, num_classes=num_classes)
    elif preds.ndim == target.ndim and preds.is_floating_point():
        preds = (preds >= threshold).to(torch.int32)
    if preds.ndim > 1:
        preds = preds.transpose(1, 0)
        target = target.transpose(1, 0)
    return preds.reshape(num_classes, -1), target.reshape(num_classes, -1)


def _allclose_recursive(res1: Any, res2: Any, atol: float = 1e-8) -> bool:
    """``allclose`` through tensors, arrays, dicts and sequences; strings and
    other values by equality."""
    if isinstance(res1, (torch.Tensor, np.ndarray)):
        a = torch.as_tensor(res1)
        b = torch.as_tensor(res2, device=a.device)
        dtype = torch.promote_types(a.dtype, b.dtype)
        return bool(torch.allclose(a.to(dtype), b.to(dtype), atol=atol))
    if isinstance(res1, str):
        return res1 == res2
    if isinstance(res1, dict):
        return all(_allclose_recursive(res1[k], res2[k], atol) for k in res1)
    if isinstance(res1, (list, tuple)):
        return all(_allclose_recursive(r1, r2, atol) for r1, r2 in zip(res1, res2))
    return res1 == res2


def _is_integer(x: torch.Tensor) -> bool:
    return not x.is_floating_point() and not x.is_complex() and x.dtype != torch.bool


def _check_retrieval_target_and_prediction_types(
    preds: torch.Tensor, target: torch.Tensor, allow_non_binary_target: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat float32 scores and int32 (float32 when graded) targets; the
    binary check reads values, so it skips inside a program."""
    if not (_is_integer(target) or target.dtype == torch.bool or target.is_floating_point()):
        raise ValueError("retrieval `target` must be boolean, integer, or float typed")
    if not preds.is_floating_point():
        raise ValueError("retrieval `preds` must be floating-point relevance scores")
    if not allow_non_binary_target and not in_program() and (target.max().item() > 1 or target.min().item() < 0):
        raise ValueError("retrieval `target` must be binary (0/1) unless the metric explicitly allows graded relevance")
    target = target.to(torch.float32) if target.is_floating_point() else target.to(torch.int32)
    return preds.to(torch.float32).reshape(-1), target.reshape(-1)


def _check_retrieval_functional_inputs(
    preds: torch.Tensor, target: torch.Tensor, allow_non_binary_target: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The checks of a single-query retrieval functional."""
    if preds.shape != target.shape:
        raise ValueError("retrieval `preds` and `target` must share one shape")
    if preds.numel() == 0 or preds.ndim == 0:
        raise ValueError("retrieval inputs must be non-scalar and contain at least one element")
    return _check_retrieval_target_and_prediction_types(preds, target, allow_non_binary_target)


def _check_retrieval_inputs(
    indexes: torch.Tensor,
    preds: torch.Tensor,
    target: torch.Tensor,
    allow_non_binary_target: bool = False,
    ignore_index: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The checks of a retrieval metric's update: flat int32 query ids,
    scores and targets. ``ignore_index`` drops rows by a boolean mask, so it
    runs eagerly (the bounded buffers drop them with a row mask instead)."""
    if indexes.shape != preds.shape or preds.shape != target.shape:
        raise ValueError("retrieval `indexes`, `preds` and `target` must all share one shape")
    if not _is_integer(indexes):
        raise ValueError("retrieval `indexes` must be integer typed (they identify queries)")
    if ignore_index is not None:
        valid = target != ignore_index
        indexes, preds, target = indexes[valid], preds[valid], target[valid]
    if indexes.numel() == 0 or indexes.ndim == 0:
        raise ValueError("after `ignore_index` filtering, retrieval inputs must still be non-scalar with at least one element")
    preds, target = _check_retrieval_target_and_prediction_types(preds, target, allow_non_binary_target)
    return indexes.to(torch.int32).reshape(-1), preds, target
