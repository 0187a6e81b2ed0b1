"""Box primitives (counterpart of ``metrics_tpu/detection/_box_ops.py``):
``torchvision.ops.box_{convert,area,iou}`` semantics as plain torch on the
input's device, without torchvision. Boxes are ``[N, 4]`` in xyxy (Pascal
VOC) unless stated otherwise."""
import torch


def _as_float(boxes: torch.Tensor) -> torch.Tensor:
    boxes = torch.as_tensor(boxes)
    return boxes.to(torch.promote_types(boxes.dtype, torch.float32))


def box_convert(boxes: torch.Tensor, in_fmt: str, out_fmt: str) -> torch.Tensor:
    """Convert between ``xyxy``/``xywh``/``cxcywh`` (torchvision semantics)."""
    allowed = ("xyxy", "xywh", "cxcywh")
    if in_fmt not in allowed or out_fmt not in allowed:
        raise ValueError(f"Unsupported box format conversion {in_fmt} -> {out_fmt}")
    if in_fmt == out_fmt:
        return boxes
    boxes = _as_float(boxes)
    a, b, c, d = boxes.unbind(-1)
    if in_fmt == "xywh":
        x1, y1, x2, y2 = a, b, a + c, b + d
    elif in_fmt == "cxcywh":
        x1, y1, x2, y2 = a - c / 2, b - d / 2, a + c / 2, b + d / 2
    else:
        x1, y1, x2, y2 = a, b, c, d
    if out_fmt == "xyxy":
        return torch.stack([x1, y1, x2, y2], dim=-1)
    if out_fmt == "xywh":
        return torch.stack([x1, y1, x2 - x1, y2 - y1], dim=-1)
    return torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], dim=-1)


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    """Area of xyxy boxes, shape ``[N]``."""
    boxes = torch.as_tensor(boxes)
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU matrix ``[N, M]`` of xyxy boxes (torchvision ``box_iou``);
    0 where the union is empty."""
    boxes1 = _as_float(boxes1)
    boxes2 = torch.as_tensor(boxes2, device=boxes1.device).to(boxes1.dtype)
    area1 = box_area(boxes1)
    area2 = box_area(boxes2)
    lt = torch.maximum(boxes1[:, None, :2], boxes2[None, :, :2])
    rb = torch.minimum(boxes1[:, None, 2:], boxes2[None, :, 2:])
    wh = torch.clamp(rb - lt, min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[:, None] + area2[None, :] - inter
    return torch.where(union > 0, inter / union, 0.0)
