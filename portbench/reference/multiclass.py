"""Plain reference of the multiclass metrics the configurations run.

Written from the metrics' definitions in plain PyTorch, with nothing of the
program under test: per row, the predicted class (the first largest logit)
and whether the target is among the ``k`` largest (ties broken towards the
lower class index); per stream, the ``[C, C]`` counts of (target, predicted
class); and from those counts each member's value in float64. ``dtype``
casts the logits before any comparison: float32 is the reference, a lower
precision is the control.
"""
from typing import Any, Dict, Sequence

import torch

#: rows of a [rows, C] block of logits the reference takes at once
BLOCK_ROWS = 8192


def row_outcomes(logits: torch.Tensor, target: torch.Tensor, top_ks: Sequence[int], dtype=torch.float32) -> Dict[str, Any]:
    """``{"pred": int64 [rows], "hits": {k: bool [rows]}}`` of ``[rows, C]``
    logits, or of ``[B, C, ...]`` logits with the class on axis 1."""
    if logits.ndim > 2:
        preds = [logits[i].to(dtype).argmax(0).reshape(-1) for i in range(logits.shape[0])]
        if any(k != 1 for k in top_ks):
            raise ValueError("top-k outcomes are taken on [rows, C] logits only")
        pred = torch.cat(preds)
        tgt = target.reshape(-1)
        return {"pred": pred, "hits": {1: pred == tgt} if top_ks else {}}
    preds, hits = [], {k: [] for k in top_ks}
    cols = torch.arange(logits.shape[1], device=logits.device)[None, :]
    for s in range(0, logits.shape[0], BLOCK_ROWS):
        x = logits[s:s + BLOCK_ROWS].to(dtype)
        t = target[s:s + BLOCK_ROWS].to(torch.int64)
        preds.append(x.argmax(1))
        t_score = x.gather(1, t[:, None])
        rank = (x > t_score).sum(1) + ((x == t_score) & (cols < t[:, None])).sum(1)
        for k in top_ks:
            hits[k].append(rank < k)
    return {"pred": torch.cat(preds), "hits": {k: torch.cat(v) for k, v in hits.items()}}


def confusion(target: torch.Tensor, pred: torch.Tensor, c: int) -> torch.Tensor:
    """``[C, C]`` int64 counts, rows the target class, columns the predicted one."""
    keys = target.reshape(-1).to(torch.int64) * c + pred.reshape(-1).to(torch.int64)
    return torch.bincount(keys, minlength=c * c).reshape(c, c)


def _f1_macro(cm: torch.Tensor) -> torch.Tensor:
    cm = cm.to(torch.float64)
    tp = torch.diagonal(cm)
    fp, fn = cm.sum(0) - tp, cm.sum(1) - tp
    precision = torch.where(tp + fp > 0, tp / (tp + fp).clamp(min=1), torch.zeros_like(tp))
    recall = torch.where(tp + fn > 0, tp / (tp + fn).clamp(min=1), torch.zeros_like(tp))
    denom = precision + recall
    f1 = torch.where(denom > 0, 2 * precision * recall / torch.where(denom > 0, denom, torch.ones_like(denom)), torch.zeros_like(tp))
    present = (tp + fp + fn) > 0
    return f1[present].mean()


def _jaccard(cm: torch.Tensor, ignore_index, reduction: str) -> torch.Tensor:
    cm = cm.to(torch.float64).clone()
    c = cm.shape[0]
    drop = ignore_index is not None and 0 <= ignore_index < c
    if drop:
        cm[ignore_index] = 0
    inter = torch.diagonal(cm)
    union = cm.sum(0) + cm.sum(1) - inter
    iou = torch.where(union > 0, inter / torch.where(union > 0, union, torch.ones_like(union)), torch.zeros_like(inter))
    if drop:
        iou = torch.cat([iou[:ignore_index], iou[ignore_index + 1:]])
    if reduction == "none":
        return iou
    if reduction == "elementwise_mean":
        return iou.mean()
    raise ValueError(f"reduction {reduction!r} is not in the reference")


def member_value(spec: Dict[str, Any], counts: Dict[str, Any]) -> torch.Tensor:
    """One member's value, from ``counts``: ``{"confmat": [C, C] int64,
    "hits": {k: int}, "rows": int}``; float64 for scores, int64 for counts."""
    cls, args = spec["class"], spec.get("args", {})
    if cls == "Accuracy":
        k = args.get("top_k") or 1
        return torch.tensor(counts["hits"][k] / counts["rows"], dtype=torch.float64)
    if cls == "F1Score" and args.get("average") == "macro":
        return _f1_macro(counts["confmat"])
    if cls == "ConfusionMatrix" and args.get("normalize") is None:
        return counts["confmat"]
    if cls == "JaccardIndex":
        return _jaccard(counts["confmat"], args.get("ignore_index"), args.get("reduction", "elementwise_mean"))
    raise ValueError(f"the reference has no {cls} with {args}")


def top_ks(collection: Dict[str, Dict[str, Any]]) -> list:
    """The ``k`` of every member that needs top-k outcomes."""
    ks = {1}
    for spec in collection.values():
        if spec["class"] == "Accuracy":
            ks.add(spec.get("args", {}).get("top_k") or 1)
    return sorted(ks)
