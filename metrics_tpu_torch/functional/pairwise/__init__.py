"""Pairwise metrics (counterpart of ``metrics_tpu/functional/pairwise/``)."""
from metrics_tpu_torch.functional.pairwise.cosine import pairwise_cosine_similarity
from metrics_tpu_torch.functional.pairwise.euclidean import pairwise_euclidean_distance
from metrics_tpu_torch.functional.pairwise.linear import pairwise_linear_similarity
from metrics_tpu_torch.functional.pairwise.manhattan import pairwise_manhattan_distance

__all__ = [
    "pairwise_cosine_similarity",
    "pairwise_euclidean_distance",
    "pairwise_linear_similarity",
    "pairwise_manhattan_distance",
]
