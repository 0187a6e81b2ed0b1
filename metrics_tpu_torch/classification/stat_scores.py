"""StatScores module metric (counterpart of ``metrics_tpu/classification/stat_scores.py``)."""
from typing import Any, Optional, Tuple

import torch

from metrics_tpu_torch.functional.classification.stat_scores import _stat_scores_compute, _stat_scores_update
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.ops.safe_ops import saturating_add
from metrics_tpu_torch.resilience import health as _health
from metrics_tpu_torch.sharding.spec import canonical_spec, class_axis_spec
from metrics_tpu_torch.utils.data import dim_zero_cat
from metrics_tpu_torch.utils.enums import AverageMethod, MDMCAverageMethod


class StatScores(Metric):
    """``[tp, fp, tn, fn, support]`` with micro, macro or samples reduction.

    micro keeps ``[]`` int64 sum states and macro ``[C]``; samples and
    samplewise keep list (cat) states. ``class_sharding`` (macro only, not
    with ``mdmc_reduce="samplewise"``) splits the ``[C]`` states over a mesh
    axis; a placed process computes the ``[C]`` sums and keeps its slice.
    """

    is_differentiable = False
    higher_is_better = None
    _sharded_update = True

    @property
    def _batch_additive(self) -> bool:
        # row-additive sums, except under macro reduce with ignore_index: its
        # -1 column marker is set once per update, not once per row
        return self.ignore_index is None or self.reduce != "macro"

    def __init__(
        self,
        threshold: float = 0.5,
        top_k: Optional[int] = None,
        reduce: str = "micro",
        num_classes: Optional[int] = None,
        ignore_index: Optional[int] = None,
        mdmc_reduce: Optional[str] = None,
        multiclass: Optional[bool] = None,
        class_sharding: Optional[Any] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)

        self.reduce = reduce
        self.mdmc_reduce = mdmc_reduce
        self.num_classes = num_classes
        self.threshold = threshold
        self.multiclass = multiclass
        self.ignore_index = ignore_index
        self.top_k = top_k

        if reduce not in ["micro", "macro", "samples"]:
            raise ValueError(f"The `reduce` {reduce} is not valid.")
        if mdmc_reduce not in [None, "samplewise", "global"]:
            raise ValueError(f"The `mdmc_reduce` {mdmc_reduce} is not valid.")
        if reduce == "macro" and (not num_classes or num_classes < 1):
            raise ValueError("When you set `reduce` as 'macro', you have to provide the number of classes.")
        if num_classes and ignore_index is not None and (not 0 <= ignore_index < num_classes or num_classes == 1):
            raise ValueError(f"The `ignore_index` {ignore_index} is not valid for inputs with {num_classes} classes")

        # a canonical tuple: see ConfusionMatrix.class_sharding
        self.class_sharding = canonical_spec(class_axis_spec(class_sharding)) or None
        if self.class_sharding is not None and (reduce != "macro" or mdmc_reduce == "samplewise"):
            # only the classwise [C] counters have a class axis to split
            raise ValueError(
                "`class_sharding` shards the per-class [num_classes] state"
                " axis and needs reduce='macro' (without"
                " mdmc_reduce='samplewise'); "
                f"got reduce={reduce!r}, mdmc_reduce={mdmc_reduce!r}."
            )

        if mdmc_reduce != "samplewise" and reduce != "samples":
            zeros_shape = [] if reduce == "micro" else [num_classes]
            for s in ("tp", "fp", "tn", "fn"):
                self.add_state(
                    s, default=torch.zeros(zeros_shape, dtype=torch.int64), dist_reduce_fx="sum", sharding=self.class_sharding
                )
        else:
            for s in ("tp", "fp", "tn", "fn"):
                # rows of int64 counts: a sync in which no rank holds one gives int64
                self.add_state(s, default=[], dist_reduce_fx="cat", placeholder=torch.int64)

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        tp, fp, tn, fn = _stat_scores_update(
            preds,
            target,
            reduce=self.reduce,
            mdmc_reduce=self.mdmc_reduce,
            threshold=self.threshold,
            num_classes=self.num_classes,
            top_k=self.top_k,
            multiclass=self.multiclass,
            ignore_index=self.ignore_index,
        )
        self._accumulate_stat_scores(tp, fp, tn, fn)

    def _accumulate_stat_scores(self, tp: torch.Tensor, fp: torch.Tensor, tn: torch.Tensor, fn: torch.Tensor) -> None:
        """Add one batch's counts (sum states) or append them (list states).
        Under a health policy the sums saturate at the int64 maximum instead
        of wrapping, and a saturation counts in ``overflow_events``."""
        if self.reduce != AverageMethod.SAMPLES and self.mdmc_reduce != MDMCAverageMethod.SAMPLEWISE:
            # a placed class-split state keeps this process's slice of the [C] sums
            tp, fp = self._local_part("tp", tp), self._local_part("fp", fp)
            tn, fn = self._local_part("tn", tn), self._local_part("fn", fn)
            if _health.health_enabled(self):
                self.tp, of_tp = saturating_add(self.tp, tp)
                self.fp, of_fp = saturating_add(self.fp, fp)
                self.tn, of_tn = saturating_add(self.tn, tn)
                self.fn, of_fn = saturating_add(self.fn, fn)
                _health.record_overflow(self, of_tp | of_fp | of_tn | of_fn)
                return
            self.tp = self.tp + tp
            self.fp = self.fp + fp
            self.tn = self.tn + tn
            self.fn = self.fn + fn
        else:
            self.tp.append(tp)
            self.fp.append(fp)
            self.tn.append(tn)
            self.fn.append(fn)

    def _get_final_stats(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        return dim_zero_cat(self.tp), dim_zero_cat(self.fp), dim_zero_cat(self.tn), dim_zero_cat(self.fn)

    def compute(self) -> torch.Tensor:
        tp, fp, tn, fn = self._get_final_stats()
        return _stat_scores_compute(tp, fp, tn, fn)
