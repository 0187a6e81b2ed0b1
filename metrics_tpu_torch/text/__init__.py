"""Text module metrics (counterpart of ``metrics_tpu/text``)."""
from metrics_tpu_torch.text.bert import BERTScore  # noqa: F401
from metrics_tpu_torch.text.bleu import BLEUScore  # noqa: F401
from metrics_tpu_torch.text.cer import CharErrorRate  # noqa: F401
from metrics_tpu_torch.text.chrf import CHRFScore  # noqa: F401
from metrics_tpu_torch.text.eed import ExtendedEditDistance  # noqa: F401
from metrics_tpu_torch.text.mer import MatchErrorRate  # noqa: F401
from metrics_tpu_torch.text.rouge import ROUGEScore  # noqa: F401
from metrics_tpu_torch.text.sacre_bleu import SacreBLEUScore  # noqa: F401
from metrics_tpu_torch.text.squad import SQuAD  # noqa: F401
from metrics_tpu_torch.text.ter import TranslationEditRate  # noqa: F401
from metrics_tpu_torch.text.wer import WordErrorRate  # noqa: F401
from metrics_tpu_torch.text.wil import WordInfoLost  # noqa: F401
from metrics_tpu_torch.text.wip import WordInfoPreserved  # noqa: F401

__all__ = [
    "BERTScore",
    "BLEUScore",
    "CHRFScore",
    "CharErrorRate",
    "ExtendedEditDistance",
    "MatchErrorRate",
    "ROUGEScore",
    "SQuAD",
    "SacreBLEUScore",
    "TranslationEditRate",
    "WordErrorRate",
    "WordInfoLost",
    "WordInfoPreserved",
]
