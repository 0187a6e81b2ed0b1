"""Device ms a collection forward spends from each `update` mark (the formatter's return) to the next mark."""
from portbench.lib import program_spans


def read(obs):
    return program_spans.from_profile(obs, program_spans.stage_device_ms, "update")
