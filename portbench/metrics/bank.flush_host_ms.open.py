"""Host ms per wave of the router calls that flushed one (the harness clock), open loop."""
from portbench.lib.readers import flush_host_ms


def read(obs):
    return flush_host_ms(obs)
