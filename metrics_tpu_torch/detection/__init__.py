"""Detection metrics (counterpart of ``metrics_tpu/detection/``): COCO mAP
and the box primitives."""
from metrics_tpu_torch.detection._box_ops import box_area, box_convert, box_iou
from metrics_tpu_torch.detection.map import MAP, MeanAveragePrecision

__all__ = ["MAP", "MeanAveragePrecision", "box_area", "box_convert", "box_iou"]
