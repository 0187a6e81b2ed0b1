"""Mean ms from the end of a wave's host `bank.dispatch` range to its `wave` mark on the device."""
from portbench.lib import program_spans


def read(obs):
    return program_spans.from_profile(obs, program_spans.launch_wait_ms)
