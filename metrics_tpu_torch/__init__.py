"""PyTorch and CUDA port of ``metrics_tpu``, slice by slice.

Ported so far: the streaming classification eval loop (``Accuracy``,
``F1Score``/``FBetaScore``, ``Precision``, ``Recall``, ``Specificity``,
``HammingDistance``, ``StatScores``, ``ConfusionMatrix``, the aggregators,
``MetricCollection`` and ``CompositionalMetric``), with the cross-process
sync on ``torch.distributed`` that every ``compute()`` runs, the curve and calibration metrics (``AUROC``,
``ROC``, ``PrecisionRecallCurve``, ``AveragePrecision``, ``AUC``, the binned
curve family and ``CalibrationError``), the regression metrics (``MeanSquaredError``
and the other ten of ``metrics_tpu/regression``) the pairwise
functionals, the rest of classification (``CohenKappa``,
``MatthewsCorrCoef``, ``JaccardIndex``, ``HingeLoss``, ``KLDivergence`` and
``dice_score``) and the retrieval metrics (``RetrievalMAP``, ``RetrievalMRR``
and six more), with their functional forms, the wrappers
(``BootStrapper``, ``ClasswiseWrapper``, ``MinMaxMetric``,
``MultioutputWrapper``, ``MetricTracker``), the state helpers
(``Metric.bind_state``, ``utils/checkpoint.py``) and image quality without
networks (``PeakSignalNoiseRatio``, the two SSIMs, ``image_gradients``), and
the embedding-based image metrics (``FrechetInceptionDistance``,
``KernelInceptionDistance``, ``InceptionScore``,
``LearnedPerceptualImagePatchSimilarity``) on torch InceptionV3 and LPIPS
networks, with ``ShardedEncoder`` and its encode-then-accumulate stream on
one device, and the text metrics (``BLEUScore``, ``SacreBLEUScore``,
``CHRFScore``, ``TranslationEditRate``, ``ExtendedEditDistance``, the word
error rate family, ``ROUGEScore``, ``SQuAD`` and ``BERTScore``, whose greedy
matching runs on the card), and the audio and detection metrics
(``SignalNoiseRatio``, ``ScaleInvariantSignalNoiseRatio``,
``SignalDistortionRatio``, ``ScaleInvariantSignalDistortionRatio``,
``PermutationInvariantTraining``, ``ShortTimeObjectiveIntelligibility``,
the ``PerceptualEvaluationSpeechQuality`` gate and COCO
``MeanAveragePrecision``); ``deprecated`` holds the old names of those, re-exported here
with ``SyncError``, ``NumericalHealthError`` and the exceptions of the
resilient sync (``SyncTimeoutError``, ``SyncIntegrityError``,
``SchemaVersionError``, ``StateIntegrityError``, ``InjectedFaultError``,
``OverloadError``). Metrics live on the GPU unless a
``device`` is given; functionals run on their inputs' device. The six
kernels of these paths (``confusion_counts``, ``multilabel_counts``,
``select_topk``, ``binned_counts``, ``binned_calibration``,
``pairwise_reduce``) are CUDA C++ in ``csrc/``, built with ``nvcc`` at
first use. Updates run through the engine (``metrics_tpu_torch.engine``):
shared update programs, replayed as CUDA graphs on the card, with pow2
bucketing, fused collection programs, non-finite screening
(``on_bad_input``), ``engine.drive`` and ``compute_async``. ``obs`` is the
observability layer: the event bus, lifecycle spans, the retrace
explainer, ``obs.snapshot()`` and the JSONL and Prometheus exporters.
``serving`` is the multi-tenant serving plane: ``MetricBank`` (one program
per wave of tenants' requests, LRU spill, the write-ahead journal and crash
recovery, shadow audits), ``RequestRouter`` and ``RequestDedup``.
``fleet`` makes banks a service whose size changes: rendezvous placement,
live migration through a ledger, kill and die recovery from the durable
store, mesh resharding, ``FleetGuard`` with hedged submits, and rolling
upgrades.
"""
from metrics_tpu_torch.aggregation import CatMetric, MaxMetric, MeanMetric, MinMetric, SumMetric
from metrics_tpu_torch.audio import (
    PerceptualEvaluationSpeechQuality,
    PermutationInvariantTraining,
    ScaleInvariantSignalDistortionRatio,
    ScaleInvariantSignalNoiseRatio,
    ShortTimeObjectiveIntelligibility,
    SignalDistortionRatio,
    SignalNoiseRatio,
)
from metrics_tpu_torch.classification import (
    AUC,
    AUROC,
    ROC,
    Accuracy,
    AveragePrecision,
    BinnedAveragePrecision,
    BinnedPrecisionRecallCurve,
    BinnedRecallAtFixedPrecision,
    CalibrationError,
    CohenKappa,
    ConfusionMatrix,
    F1Score,
    FBetaScore,
    HammingDistance,
    HingeLoss,
    JaccardIndex,
    KLDivergence,
    MatthewsCorrCoef,
    Precision,
    PrecisionRecallCurve,
    Recall,
    Specificity,
    StatScores,
)
from metrics_tpu_torch import engine  # noqa: F401
from metrics_tpu_torch import fleet  # noqa: F401
from metrics_tpu_torch import obs  # noqa: F401
from metrics_tpu_torch import parallel  # noqa: F401
from metrics_tpu_torch import resilience  # noqa: F401
from metrics_tpu_torch import serving  # noqa: F401
from metrics_tpu_torch import sharding  # noqa: F401
from metrics_tpu_torch.collections import MetricCollection
from metrics_tpu_torch.deprecated import (
    F1,
    FID,
    IS,
    KID,
    LPIPS,
    MAP,
    PESQ,
    PIT,
    PSNR,
    SDR,
    SI_SDR,
    SI_SNR,
    SNR,
    SSIM,
    STOI,
    FBeta,
    Hinge,
    IoU,
    MatthewsCorrcoef,
    PearsonCorrcoef,
    SpearmanCorrcoef,
)
from metrics_tpu_torch.detection import MeanAveragePrecision
from metrics_tpu_torch.encoders import ShardedEncoder
from metrics_tpu_torch.image import (
    FrechetInceptionDistance,
    InceptionScore,
    KernelInceptionDistance,
    LearnedPerceptualImagePatchSimilarity,
    MultiScaleStructuralSimilarityIndexMeasure,
    PeakSignalNoiseRatio,
    StructuralSimilarityIndexMeasure,
)
from metrics_tpu_torch.interop import state_from_jax, state_to_jax
from metrics_tpu_torch.metric import CompositionalMetric, Metric
from metrics_tpu_torch.ops.registry import kernel_stats, reset_kernel_stats
from metrics_tpu_torch.regression import (
    CosineSimilarity,
    ExplainedVariance,
    MeanAbsoluteError,
    MeanAbsolutePercentageError,
    MeanSquaredError,
    MeanSquaredLogError,
    PearsonCorrCoef,
    R2Score,
    SpearmanCorrCoef,
    SymmetricMeanAbsolutePercentageError,
    TweedieDevianceScore,
)
from metrics_tpu_torch.text import (
    BERTScore,
    BLEUScore,
    CharErrorRate,
    CHRFScore,
    ExtendedEditDistance,
    MatchErrorRate,
    ROUGEScore,
    SacreBLEUScore,
    SQuAD,
    TranslationEditRate,
    WordErrorRate,
    WordInfoLost,
    WordInfoPreserved,
)
from metrics_tpu_torch.retrieval import (
    RetrievalFallOut,
    RetrievalHitRate,
    RetrievalMAP,
    RetrievalMRR,
    RetrievalMetric,
    RetrievalNormalizedDCG,
    RetrievalPrecision,
    RetrievalRPrecision,
    RetrievalRecall,
)
from metrics_tpu_torch.utils.exceptions import (
    InjectedFaultError,
    NumericalHealthError,
    OverloadError,
    SchemaVersionError,
    StateIntegrityError,
    SyncError,
    SyncIntegrityError,
    SyncTimeoutError,
)
from metrics_tpu_torch.wrappers import (
    BootStrapper,
    ClasswiseWrapper,
    MetricTracker,
    MinMaxMetric,
    MultioutputWrapper,
)

__all__ = [
    "InjectedFaultError",
    "SchemaVersionError",
    "StateIntegrityError",
    "AUC",
    "AUROC",
    "Accuracy",
    "AveragePrecision",
    "BERTScore",
    "BLEUScore",
    "BinnedAveragePrecision",
    "BinnedPrecisionRecallCurve",
    "BinnedRecallAtFixedPrecision",
    "BootStrapper",
    "CHRFScore",
    "CalibrationError",
    "CatMetric",
    "CharErrorRate",
    "ClasswiseWrapper",
    "CohenKappa",
    "CompositionalMetric",
    "ConfusionMatrix",
    "CosineSimilarity",
    "ExplainedVariance",
    "ExtendedEditDistance",
    "F1",
    "F1Score",
    "FBeta",
    "FBetaScore",
    "FID",
    "FrechetInceptionDistance",
    "HammingDistance",
    "Hinge",
    "HingeLoss",
    "IS",
    "InceptionScore",
    "IoU",
    "JaccardIndex",
    "KID",
    "KLDivergence",
    "KernelInceptionDistance",
    "LPIPS",
    "LearnedPerceptualImagePatchSimilarity",
    "MAP",
    "MatchErrorRate",
    "MatthewsCorrCoef",
    "MatthewsCorrcoef",
    "MaxMetric",
    "MeanAbsoluteError",
    "MeanAbsolutePercentageError",
    "MeanAveragePrecision",
    "MeanMetric",
    "MeanSquaredError",
    "MeanSquaredLogError",
    "Metric",
    "MetricCollection",
    "MetricTracker",
    "MinMaxMetric",
    "MinMetric",
    "MultiScaleStructuralSimilarityIndexMeasure",
    "MultioutputWrapper",
    "NumericalHealthError",
    "OverloadError",
    "PESQ",
    "PIT",
    "PSNR",
    "PeakSignalNoiseRatio",
    "PearsonCorrCoef",
    "PearsonCorrcoef",
    "PerceptualEvaluationSpeechQuality",
    "PermutationInvariantTraining",
    "Precision",
    "PrecisionRecallCurve",
    "R2Score",
    "ROC",
    "ROUGEScore",
    "Recall",
    "RetrievalFallOut",
    "RetrievalHitRate",
    "RetrievalMAP",
    "RetrievalMRR",
    "RetrievalMetric",
    "RetrievalNormalizedDCG",
    "RetrievalPrecision",
    "RetrievalRPrecision",
    "RetrievalRecall",
    "SDR",
    "SI_SDR",
    "SI_SNR",
    "SNR",
    "SQuAD",
    "SSIM",
    "STOI",
    "SacreBLEUScore",
    "ScaleInvariantSignalDistortionRatio",
    "ScaleInvariantSignalNoiseRatio",
    "ShardedEncoder",
    "ShortTimeObjectiveIntelligibility",
    "SignalDistortionRatio",
    "SignalNoiseRatio",
    "SpearmanCorrCoef",
    "SpearmanCorrcoef",
    "Specificity",
    "StatScores",
    "StructuralSimilarityIndexMeasure",
    "SumMetric",
    "SymmetricMeanAbsolutePercentageError",
    "SyncError",
    "SyncIntegrityError",
    "SyncTimeoutError",
    "TranslationEditRate",
    "TweedieDevianceScore",
    "WordErrorRate",
    "WordInfoLost",
    "WordInfoPreserved",
    "kernel_stats",
    "reset_kernel_stats",
    "state_from_jax",
    "state_to_jax",
]

# warmup manifests (engine/warmup.py): with METRICS_TPU_WARMUP_MANIFEST set,
# an existing manifest warms this worker now (every metric module above is
# importable, so its templates unpickle) and a missing one starts recording,
# saved at exit
from metrics_tpu_torch.engine import _warmup as _engine_warmup  # noqa: E402

_engine_warmup._maybe_autowire_from_env()
del _engine_warmup
