"""Retrieval module metrics (counterpart of ``metrics_tpu/retrieval``)."""
from metrics_tpu_torch.retrieval.average_precision import RetrievalMAP
from metrics_tpu_torch.retrieval.base import RetrievalMetric
from metrics_tpu_torch.retrieval.fall_out import RetrievalFallOut
from metrics_tpu_torch.retrieval.hit_rate import RetrievalHitRate
from metrics_tpu_torch.retrieval.ndcg import RetrievalNormalizedDCG
from metrics_tpu_torch.retrieval.precision import RetrievalPrecision
from metrics_tpu_torch.retrieval.r_precision import RetrievalRPrecision
from metrics_tpu_torch.retrieval.recall import RetrievalRecall
from metrics_tpu_torch.retrieval.reciprocal_rank import RetrievalMRR

__all__ = [
    "RetrievalFallOut",
    "RetrievalHitRate",
    "RetrievalMAP",
    "RetrievalMRR",
    "RetrievalMetric",
    "RetrievalNormalizedDCG",
    "RetrievalPrecision",
    "RetrievalRPrecision",
    "RetrievalRecall",
]
