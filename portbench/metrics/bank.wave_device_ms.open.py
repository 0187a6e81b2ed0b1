"""Mean device ms of a bank wave, from its `wave` mark to its `wave_end` mark."""
from portbench.lib import program_spans


def read(obs):
    return program_spans.from_profile(obs, program_spans.wave_device_ms)
