"""COCO mean average precision and recall (counterpart of
``metrics_tpu/detection/map.py``).

States: per-image lists of tensors on the metric's device (float64 boxes
in xyxy, float64 scores, int64 labels). ``update`` validates, converts the
boxes on the device and appends: no host read. ``compute()`` concatenates
each state once, copies it to pinned host memory without blocking, waits
once, and runs the host float64 evaluation (greedy COCO matching,
precision and recall accumulation, the summaries), a copy of the JAX
package's: the same float64 inputs give the same fourteen numbers, bit for
bit. They come back as float32 tensors on the metric's device.

Sync keeps the image boundaries: each per-image state travels as its rows
and its per-image lengths, and is split again per rank, so a ``compute()``
under ``torch.distributed`` and the pure ``sync_state`` evaluate every
rank's images as images (a plain gather would merge each rank's boxes into
one image).
"""
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from metrics_tpu_torch.detection._box_ops import box_convert
from metrics_tpu_torch.metric import Metric

_AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}

#: the per-image states: row width (0 for a vector) and dtype
_PER_IMAGE = {
    "detection_boxes": (4, torch.float64),
    "detection_scores": (0, torch.float64),
    "detection_labels": (0, torch.int64),
    "groundtruth_boxes": (4, torch.float64),
    "groundtruth_labels": (0, torch.int64),
}
_LENGTHS = "_lengths"  # suffix of a per-image state's lengths leaf in a sync


def _np_box_area(boxes: np.ndarray) -> np.ndarray:
    return (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])


def _input_validator(preds: Sequence[Dict[str, Any]], targets: Sequence[Dict[str, Any]]) -> None:
    """Validate the list-of-dicts input contract."""
    if not isinstance(preds, Sequence):
        raise ValueError("Expected argument `preds` to be of type Sequence")
    if not isinstance(targets, Sequence):
        raise ValueError("Expected argument `target` to be of type Sequence")
    if len(preds) != len(targets):
        raise ValueError("Expected argument `preds` and `target` to have the same length")
    for k in ("boxes", "scores", "labels"):
        if any(k not in p for p in preds):
            raise ValueError(f"Expected all dicts in `preds` to contain the `{k}` key")
    for k in ("boxes", "labels"):
        if any(k not in p for p in targets):
            raise ValueError(f"Expected all dicts in `target` to contain the `{k}` key")


def _rows(parts: List[torch.Tensor], name: str, device: torch.device) -> torch.Tensor:
    """A per-image state's tensors as one ``[n, 4]`` or ``[n]`` tensor."""
    width, dtype = _PER_IMAGE[name]
    if not parts:
        return torch.zeros((0, width) if width else (0,), dtype=dtype, device=device)
    return torch.cat([p.reshape(-1, width) if width else p.reshape(-1) for p in parts])


class MeanAveragePrecision(Metric):
    """COCO-style mAP/mAR over streamed detection results.

    Boxes are Pascal VOC xyxy by default (``box_format`` converts). Returns
    the 12 COCO scalars and the per-class values (``-1`` each without
    ``class_metrics``).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import MeanAveragePrecision
        >>> metric = MeanAveragePrecision(device="cpu")
        >>> metric.update(
        ...     [dict(boxes=torch.tensor([[10.0, 10.0, 60.0, 60.0]]),
        ...           scores=torch.tensor([0.9]), labels=torch.tensor([0]))],
        ...     [dict(boxes=torch.tensor([[10.0, 10.0, 60.0, 60.0]]), labels=torch.tensor([0]))],
        ... )
        >>> print(round(float(metric.compute()['map']), 4))
        1.0
    """

    is_differentiable = False
    higher_is_better = True
    _compute_is_host_side = True

    def __init__(
        self,
        box_format: str = "xyxy",
        iou_thresholds: Optional[List[float]] = None,
        rec_thresholds: Optional[List[float]] = None,
        max_detection_thresholds: Optional[List[int]] = None,
        class_metrics: bool = False,
        **kwargs: Any,
    ) -> None:
        kwargs.setdefault("jit_update", False)  # ragged per-image states
        super().__init__(**kwargs)
        allowed_box_formats = ("xyxy", "xywh", "cxcywh")
        if box_format not in allowed_box_formats:
            raise ValueError(f"Expected argument `box_format` to be one of {allowed_box_formats} but got {box_format}")
        self.box_format = box_format
        self.iou_thresholds = np.asarray(iou_thresholds if iou_thresholds is not None else np.linspace(0.5, 0.95, 10))
        self.rec_thresholds = np.asarray(rec_thresholds if rec_thresholds is not None else np.linspace(0.0, 1.0, 101))
        self.max_detection_thresholds = sorted(max_detection_thresholds or [1, 10, 100])
        if not isinstance(class_metrics, bool):
            raise ValueError("Expected argument `class_metrics` to be a boolean")
        self.class_metrics = class_metrics
        for name in _PER_IMAGE:
            self.add_state(name, default=[], dist_reduce_fx=None)

    def _to_state(self, x: Any, name: str) -> torch.Tensor:
        width, dtype = _PER_IMAGE[name]
        x = torch.as_tensor(x).to(device=self.device, dtype=dtype)
        if not width:
            return x.reshape(-1)
        return box_convert(x.reshape(-1, 4), self.box_format, "xyxy")

    def update(self, preds: Sequence[Dict[str, Any]], target: Sequence[Dict[str, Any]]) -> None:
        """Append each image's detections and ground truths."""
        _input_validator(preds, target)
        for p in preds:
            self.detection_boxes.append(self._to_state(p["boxes"], "detection_boxes"))
            self.detection_scores.append(self._to_state(p["scores"], "detection_scores"))
            self.detection_labels.append(self._to_state(p["labels"], "detection_labels"))
        for t in target:
            self.groundtruth_boxes.append(self._to_state(t["boxes"], "groundtruth_boxes"))
            self.groundtruth_labels.append(self._to_state(t["labels"], "groundtruth_labels"))

    # ------------------------------------------------------------------
    # sync: the per-image states travel as rows and per-image lengths
    # ------------------------------------------------------------------
    def _sync_leaves(self, state: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        leaves = {}
        for name in sorted(self._reductions):
            parts = state[name]
            if name not in _PER_IMAGE:
                leaves[name] = parts
                continue
            leaves[name] = _rows(parts, name, self.device)
            lengths = np.asarray([p.shape[0] for p in parts], dtype=np.int64)
            leaves[name + _LENGTHS] = torch.from_numpy(lengths).to(self.device)
        return leaves

    def _reduce_gathered(self, gathered: Dict[str, List[torch.Tensor]]) -> Dict[str, Any]:
        per_image = set(_PER_IMAGE) | {name + _LENGTHS for name in _PER_IMAGE}
        out = super()._reduce_gathered({n: v for n, v in gathered.items() if n not in per_image})
        names = sorted(_PER_IMAGE)
        # every state's per-image lengths from every rank, in one host read
        lengths = torch.cat([torch.cat(gathered[name + _LENGTHS]) for name in names]).tolist()
        at = 0
        for name in names:
            rows = torch.cat(gathered[name])
            n_images = sum(int(x.shape[0]) for x in gathered[name + _LENGTHS])
            out[name] = list(torch.split(rows, lengths[at : at + n_images]))
            at += n_images
        return out

    # ------------------------------------------------------------------
    # host evaluation
    # ------------------------------------------------------------------
    def _host_states(self) -> Dict[str, Any]:
        """Each per-image state as one float64 or int64 numpy array, copied
        from the device once, with the per-image counts."""
        device = self.device
        pinned = device.type == "cuda"
        host: Dict[str, Any] = {}
        for name in _PER_IMAGE:
            parts = getattr(self, name)
            rows = _rows(parts, name, device)
            buf = torch.empty(rows.shape, dtype=rows.dtype, pin_memory=pinned)
            buf.copy_(rows, non_blocking=pinned)
            host[name] = buf
            host[name + _LENGTHS] = [int(p.shape[0]) for p in parts]
        if pinned:
            torch.cuda.current_stream(device).synchronize()
        return {k: (v.numpy() if isinstance(v, torch.Tensor) else v) for k, v in host.items()}

    @staticmethod
    def _get_classes(host: Dict[str, Any]) -> List[int]:
        if host["detection_labels" + _LENGTHS] or host["groundtruth_labels" + _LENGTHS]:
            return sorted(set(np.concatenate([host["detection_labels"], host["groundtruth_labels"]]).tolist()))
        return []

    def _calculate_class(
        self,
        prec_out: np.ndarray,
        rec_out: np.ndarray,
        d_boxes: np.ndarray,
        d_scores: np.ndarray,
        d_img: np.ndarray,
        g_boxes: np.ndarray,
        g_img: np.ndarray,
    ) -> None:
        """All precision/recall cells of ONE class, as a single padded numpy
        program.

        Every image holding this class becomes one row of padded
        ``[pairs, dets]`` / ``[pairs, gts]`` arrays; the greedy COCO matching
        then runs vectorized over (pairs, area ranges, IoU thresholds) at
        once. Only the per-detection scan, which is order-dependent (each
        detection consumes a ground truth), is a loop, of at most
        ``max_detection_thresholds[-1]`` iterations. ``prec_out [T,R,A,M]``
        and ``rec_out [T,A,M]`` are filled in place.
        """
        n_thr = len(self.iou_thresholds)
        rec_thrs = np.asarray(self.rec_thresholds, np.float64)
        area_values = np.asarray(list(_AREA_RANGES.values()), np.float64)  # [A, 2]
        n_area = area_values.shape[0]
        max_det_overall = self.max_detection_thresholds[-1]

        pair_imgs = np.union1d(np.unique(d_img), np.unique(g_img))
        n_pair = len(pair_imgs)
        if n_pair == 0:
            return
        d_pair = np.searchsorted(pair_imgs, d_img)
        g_pair = np.searchsorted(pair_imgs, g_img)

        # score-descending stable order within each pair, computed in one pass
        order = np.lexsort((-d_scores, d_pair))
        d_pair, d_boxes, d_scores = d_pair[order], d_boxes[order], d_scores[order]

        def ragged_to_padded(pair_ids: np.ndarray, cap: Optional[int]) -> Tuple[np.ndarray, np.ndarray, int]:
            """Position of each element within its pair + keep mask + pad width."""
            counts = np.bincount(pair_ids, minlength=n_pair)
            width = int(counts.max()) if counts.size else 0
            if cap is not None:
                width = min(width, cap)
            offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
            pos = np.arange(len(pair_ids)) - offsets[pair_ids]
            return pos, pos < width, width

        d_pos, d_keep, n_det = ragged_to_padded(d_pair, max_det_overall)
        g_pos, g_keep, n_gt = ragged_to_padded(g_pair, None)

        valid_d = np.zeros((n_pair, n_det), bool)
        valid_d[d_pair[d_keep], d_pos[d_keep]] = True
        valid_g = np.zeros((n_pair, n_gt), bool)
        valid_g[g_pair[g_keep], g_pos[g_keep]] = True
        boxes_d = np.zeros((n_pair, n_det, 4))
        boxes_d[d_pair[d_keep], d_pos[d_keep]] = d_boxes[d_keep]
        scores_d = np.zeros((n_pair, n_det))
        scores_d[d_pair[d_keep], d_pos[d_keep]] = d_scores[d_keep]
        boxes_g = np.zeros((n_pair, n_gt, 4))
        boxes_g[g_pair[g_keep], g_pos[g_keep]] = g_boxes[g_keep]
        areas_d = _np_box_area(boxes_d.reshape(-1, 4)).reshape(n_pair, n_det)
        areas_g = _np_box_area(boxes_g.reshape(-1, 4)).reshape(n_pair, n_gt)

        # batched IoU [P, D, G]
        if n_det and n_gt:
            lt = np.maximum(boxes_d[:, :, None, :2], boxes_g[:, None, :, :2])
            rb = np.minimum(boxes_d[:, :, None, 2:], boxes_g[:, None, :, 2:])
            wh = np.clip(rb - lt, 0, None)
            inter = wh[..., 0] * wh[..., 1]
            union = areas_d[:, :, None] + areas_g[:, None, :] - inter
            ious = inter / np.where(union > 0, union, 1.0)

        lo = area_values[:, 0][None, :, None]
        hi = area_values[:, 1][None, :, None]
        # [P, A, G]; padded gt slots are permanently ignored
        gt_ig = (areas_g[:, None, :] < lo) | (areas_g[:, None, :] > hi) | ~valid_g[:, None, :]

        # Greedy matching, vectorized over (pair, area, threshold): each
        # detection takes the highest-IoU still-unmatched gt with iou >= thr,
        # preferring non-ignored gts, ties to the highest gt index (the
        # scan-order semantics of pycocotools).
        gt_matched = np.zeros((n_pair, n_area, n_thr, n_gt), bool)
        det_match = np.zeros((n_pair, n_area, n_thr, n_det), bool)
        det_ign = np.zeros((n_pair, n_area, n_thr, n_det), bool)
        if n_det and n_gt:
            thr_eff = np.minimum(np.asarray(self.iou_thresholds, np.float64), 1 - 1e-10)
            thr_b = thr_eff[None, None, :, None]  # [1,1,T,1]
            ig_b = gt_ig[:, :, None, :]  # [P,A,1,G]
            gt_ig_bcast = np.broadcast_to(ig_b, gt_matched.shape)
            gm_flat = gt_matched.reshape(-1, n_gt)  # view: writes land in gt_matched
            for d in range(n_det):
                iou_d = ious[:, d, :][:, None, None, :]  # [P,1,1,G]
                cand = (iou_d >= thr_b) & ~gt_matched
                cand &= valid_d[:, d][:, None, None, None] & valid_g[:, None, None, :]
                has_any = np.zeros((n_pair, n_area, n_thr), bool)
                m_idx = np.zeros((n_pair, n_area, n_thr), np.int64)
                for group in (cand & ~ig_b, cand & ig_b):
                    has = group.any(-1)
                    vals = np.where(group, iou_d, -np.inf)
                    best = vals.max(-1)
                    # ties go to the LAST gt index (the scan updates on ==)
                    idx = n_gt - 1 - np.argmax(vals[..., ::-1] == best[..., None], axis=-1)
                    m_idx = np.where(has & ~has_any, idx, m_idx)
                    has_any |= has
                det_match[:, :, :, d] = has_any
                det_ign[:, :, :, d] = has_any & np.take_along_axis(gt_ig_bcast, m_idx[..., None], axis=-1)[..., 0]
                rows = np.nonzero(has_any.reshape(-1))[0]
                gm_flat[rows, m_idx.reshape(-1)[rows]] = True

        # unmatched detections outside the area range are ignored
        d_out = (areas_d[:, None, :] < lo) | (areas_d[:, None, :] > hi)  # [P, A, D]
        det_ign |= (~det_match) & d_out[:, :, None, :]

        # accumulation: back to (image-ascending, score-descending) order,
        # then one global mergesort
        flat_valid = valid_d.reshape(-1)
        sel = np.nonzero(flat_valid)[0]
        glob_order = np.argsort(-scores_d.reshape(-1)[sel], kind="mergesort")
        sel = sel[glob_order]
        pos_sorted = (sel % n_det) if n_det else sel
        match_flat = det_match.transpose(1, 2, 0, 3).reshape(n_area, n_thr, -1)[:, :, sel]
        ign_flat = det_ign.transpose(1, 2, 0, 3).reshape(n_area, n_thr, -1)[:, :, sel]
        npig_per_area = (~gt_ig).sum(axis=(0, 2))  # [A]

        eps = np.finfo(np.float64).eps
        for idx_area in range(n_area):
            npig = int(npig_per_area[idx_area])
            if npig == 0:
                continue  # the cell stays -1
            for idx_m, max_det in enumerate(self.max_detection_thresholds):
                keep = pos_sorted < max_det
                matches = match_flat[idx_area][:, keep]  # [T, n]
                ignores = ign_flat[idx_area][:, keep]
                tp_sum = np.cumsum(matches & ~ignores, axis=1, dtype=np.float64)
                fp_sum = np.cumsum(~matches & ~ignores, axis=1, dtype=np.float64)
                nd = tp_sum.shape[1]
                rc = tp_sum / npig
                pr = tp_sum / (fp_sum + tp_sum + eps)
                rec_out[:, idx_area, idx_m] = rc[:, -1] if nd else 0.0
                # monotone (zigzag-free) precision envelope, all thresholds at once
                pr_env = np.maximum.accumulate(pr[:, ::-1], axis=1)[:, ::-1]
                prec = np.zeros((n_thr, len(rec_thrs)))
                for t in range(n_thr):
                    idx = np.searchsorted(rc[t], rec_thrs, side="left")
                    ok = idx < nd
                    prec[t, ok] = pr_env[t, idx[ok]]
                prec_out[:, :, idx_area, idx_m] = prec

    def _calculate(self, class_ids: List[int], host: Dict[str, Any]) -> Tuple[np.ndarray, np.ndarray]:
        """Full precision [T,R,K,A,M] / recall [T,K,A,M] grids, one
        :meth:`_calculate_class` per class."""
        nb_imgs = len(host["groundtruth_boxes" + _LENGTHS])
        nb = (len(self.iou_thresholds), len(self.rec_thresholds), len(class_ids),
              len(_AREA_RANGES), len(self.max_detection_thresholds))
        precision = -np.ones(nb)
        recall = -np.ones((nb[0], nb[2], nb[3], nb[4]))
        if nb_imgs == 0 or not class_ids:
            return precision, recall

        det_counts = host["detection_scores" + _LENGTHS]
        gt_counts = host["groundtruth_labels" + _LENGTHS]
        det_img = np.repeat(np.arange(len(det_counts)), det_counts)
        gt_img = np.repeat(np.arange(len(gt_counts)), gt_counts)
        det_boxes, det_scores, det_labels = (host[n] for n in ("detection_boxes", "detection_scores", "detection_labels"))
        gt_boxes, gt_labels = host["groundtruth_boxes"], host["groundtruth_labels"]

        for idx_cls, class_id in enumerate(class_ids):
            dsel = det_labels == class_id
            gsel = gt_labels == class_id
            self._calculate_class(
                precision[:, :, idx_cls],
                recall[:, idx_cls],
                det_boxes[dsel],
                det_scores[dsel],
                det_img[dsel],
                gt_boxes[gsel],
                gt_img[gsel],
            )
        return precision, recall

    def _summarize(
        self,
        precision: np.ndarray,
        recall: np.ndarray,
        avg_prec: bool,
        iou_threshold: Optional[float] = None,
        area_range: str = "all",
        max_dets: Optional[int] = None,
    ) -> float:
        """Mean over the valid cells."""
        area_idx = list(_AREA_RANGES).index(area_range)
        mdet_idx = self.max_detection_thresholds.index(
            max_dets if max_dets is not None else self.max_detection_thresholds[-1]
        )
        if avg_prec:
            vals = precision[:, :, :, area_idx, mdet_idx]
        else:
            vals = recall[:, :, area_idx, mdet_idx]
        if iou_threshold is not None:
            thr_idx = np.where(np.isclose(self.iou_thresholds, iou_threshold))[0]
            vals = vals[thr_idx]
        vals = vals[vals > -1]
        return float(vals.mean()) if vals.size else -1.0

    def compute(self) -> Dict[str, torch.Tensor]:
        """The 12 COCO scalars and the per-class values, float32 on the metric's device."""
        host = self._host_states()
        class_ids = self._get_classes(host)
        precision, recall = self._calculate(class_ids, host)
        last_max_det = self.max_detection_thresholds[-1]

        metrics: Dict[str, Any] = {}
        metrics["map"] = self._summarize(precision, recall, True)
        metrics["map_50"] = self._summarize(precision, recall, True, iou_threshold=0.5)
        metrics["map_75"] = self._summarize(precision, recall, True, iou_threshold=0.75)
        metrics["map_small"] = self._summarize(precision, recall, True, area_range="small")
        metrics["map_medium"] = self._summarize(precision, recall, True, area_range="medium")
        metrics["map_large"] = self._summarize(precision, recall, True, area_range="large")
        for max_det in self.max_detection_thresholds:
            metrics[f"mar_{max_det}"] = self._summarize(precision, recall, False, max_dets=max_det)
        metrics["mar_small"] = self._summarize(precision, recall, False, area_range="small")
        metrics["mar_medium"] = self._summarize(precision, recall, False, area_range="medium")
        metrics["mar_large"] = self._summarize(precision, recall, False, area_range="large")

        map_per_class: Any = [-1.0]
        mar_per_class: Any = [-1.0]
        if self.class_metrics:
            map_per_class, mar_per_class = [], []
            for idx_cls in range(len(class_ids)):
                p_cls = precision[:, :, idx_cls : idx_cls + 1]
                r_cls = recall[:, idx_cls : idx_cls + 1]
                map_per_class.append(self._summarize(p_cls, r_cls, True))
                mar_per_class.append(self._summarize(p_cls, r_cls, False, max_dets=last_max_det))
        metrics["map_per_class"] = map_per_class
        metrics[f"mar_{last_max_det}_per_class"] = mar_per_class
        # one host-to-device copy of every value
        values = [np.asarray(v, dtype=np.float32) for v in metrics.values()]
        flat = torch.from_numpy(np.concatenate([v.reshape(-1) for v in values])).to(self.device)
        parts = torch.split(flat, [v.size for v in values])
        return {k: p.reshape(v.shape) for k, p, v in zip(metrics, parts, values)}


# deprecated alias kept for reference API parity
MAP = MeanAveragePrecision
