"""Case-insensitive string enums (counterpart of ``metrics_tpu/utils/enums.py``)."""
from enum import Enum
from typing import Optional, Union


class EnumStr(str, Enum):
    """String enum whose ``from_str`` lookup is case- and separator-insensitive."""

    @classmethod
    def from_str(cls, value: str) -> Optional["EnumStr"]:
        try:
            return cls[value.replace("-", "_").upper()]
        except KeyError:
            return None

    def __eq__(self, other: Union[str, "EnumStr", None]) -> bool:  # type: ignore[override]
        if other is None:
            # `average=None` must match AverageMethod.NONE (whose str value is "None")
            return self.value == "None"
        other = other.value if isinstance(other, Enum) else str(other)
        return self.value.lower() == other.lower()

    def __hash__(self) -> int:
        return hash(self.value.lower())


class DataType(EnumStr):
    """Classification input case."""

    BINARY = "binary"
    MULTILABEL = "multi-label"
    MULTICLASS = "multi-class"
    MULTIDIM_MULTICLASS = "multi-dim multi-class"


class AverageMethod(EnumStr):
    """Score averaging method."""

    MICRO = "micro"
    MACRO = "macro"
    WEIGHTED = "weighted"
    NONE = None  # type: ignore[assignment]
    SAMPLES = "samples"


class MDMCAverageMethod(EnumStr):
    """Multi-dim multi-class averaging."""

    GLOBAL = "global"
    SAMPLEWISE = "samplewise"
