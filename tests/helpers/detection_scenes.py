"""Seeded synthetic detection scenes for the port's mAP tests (numpy only).

Each image holds 0-6 ground-truth boxes of ``n_cls`` classes and 0-11
detections: jittered copies of its ground truths with their labels (80%)
or a random label, among them class ``n_cls`` that no ground truth has,
and random scores. Some images have no detection, some no ground truth.
Boxes are xyxy, or converted to ``box_format``.
"""
from typing import Dict, List, Tuple

import numpy as np


def _from_xyxy(boxes: np.ndarray, box_format: str) -> np.ndarray:
    x1, y1, x2, y2 = boxes.T
    if box_format == "xywh":
        return np.stack([x1, y1, x2 - x1, y2 - y1], axis=1)
    if box_format == "cxcywh":
        return np.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], axis=1)
    return boxes


def detection_scenes(
    seed: int, n_img: int, n_cls: int = 4, box_format: str = "xyxy"
) -> Tuple[List[Dict[str, np.ndarray]], List[Dict[str, np.ndarray]]]:
    rng = np.random.default_rng(seed)
    preds, targets = [], []
    for _ in range(n_img):
        g = int(rng.integers(0, 7))
        xy = rng.uniform(0, 300, (g, 2))
        wh = rng.uniform(4, 150, (g, 2))
        gt = np.concatenate([xy, xy + wh], axis=1)
        gl = rng.integers(0, n_cls, g)
        d = int(rng.integers(0, 12))
        if g:
            src = rng.integers(0, g, d)
            det = gt[src] + rng.normal(0, 6, (d, 4))
            dl = np.where(rng.random(d) < 0.8, gl[src], rng.integers(0, n_cls + 1, d))
        else:
            det = rng.uniform(0, 300, (d, 4))
            dl = rng.integers(0, n_cls + 1, d)
        det[:, 2:] = np.maximum(det[:, 2:], det[:, :2] + 1)
        preds.append({"boxes": _from_xyxy(det, box_format), "scores": rng.random(d), "labels": dl.astype(np.int64)})
        targets.append({"boxes": _from_xyxy(gt, box_format), "labels": gl.astype(np.int64)})
    return preds, targets
