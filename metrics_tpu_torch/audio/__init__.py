"""Audio metrics (counterpart of ``metrics_tpu/audio/``): SNR, SI-SNR, SDR,
SI-SDR, PIT, STOI/ESTOI and the PESQ gate."""
from metrics_tpu_torch.audio.pesq import PerceptualEvaluationSpeechQuality
from metrics_tpu_torch.audio.pit import PermutationInvariantTraining
from metrics_tpu_torch.audio.sdr import ScaleInvariantSignalDistortionRatio, SignalDistortionRatio
from metrics_tpu_torch.audio.snr import ScaleInvariantSignalNoiseRatio, SignalNoiseRatio
from metrics_tpu_torch.audio.stoi import ShortTimeObjectiveIntelligibility

__all__ = [
    "PerceptualEvaluationSpeechQuality",
    "PermutationInvariantTraining",
    "ScaleInvariantSignalDistortionRatio",
    "ScaleInvariantSignalNoiseRatio",
    "ShortTimeObjectiveIntelligibility",
    "SignalDistortionRatio",
    "SignalNoiseRatio",
]
