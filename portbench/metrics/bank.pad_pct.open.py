"""The bank's pow2 pad requests over all the requests its waves launched (obs.trace counts), in %."""
from portbench.lib import program_spans


def read(obs):
    return program_spans.pad_pct(obs)
