"""Composition wrappers (counterpart of ``metrics_tpu/wrappers/``)."""
from metrics_tpu_torch.wrappers.bootstrapping import BootStrapper
from metrics_tpu_torch.wrappers.classwise import ClasswiseWrapper
from metrics_tpu_torch.wrappers.minmax import MinMaxMetric
from metrics_tpu_torch.wrappers.multioutput import MultioutputWrapper
from metrics_tpu_torch.wrappers.tracker import MetricTracker

__all__ = ["BootStrapper", "ClasswiseWrapper", "MinMaxMetric", "MultioutputWrapper", "MetricTracker"]
