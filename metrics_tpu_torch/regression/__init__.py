from metrics_tpu_torch.regression.cosine_similarity import CosineSimilarity
from metrics_tpu_torch.regression.explained_variance import ExplainedVariance
from metrics_tpu_torch.regression.log_mse import MeanSquaredLogError
from metrics_tpu_torch.regression.mae import MeanAbsoluteError
from metrics_tpu_torch.regression.mape import MeanAbsolutePercentageError
from metrics_tpu_torch.regression.mse import MeanSquaredError
from metrics_tpu_torch.regression.pearson import PearsonCorrCoef
from metrics_tpu_torch.regression.r2 import R2Score
from metrics_tpu_torch.regression.spearman import SpearmanCorrCoef
from metrics_tpu_torch.regression.symmetric_mape import SymmetricMeanAbsolutePercentageError
from metrics_tpu_torch.regression.tweedie_deviance import TweedieDevianceScore

__all__ = [
    "CosineSimilarity",
    "ExplainedVariance",
    "MeanAbsoluteError",
    "MeanAbsolutePercentageError",
    "MeanSquaredError",
    "MeanSquaredLogError",
    "PearsonCorrCoef",
    "R2Score",
    "SpearmanCorrCoef",
    "SymmetricMeanAbsolutePercentageError",
    "TweedieDevianceScore",
]
