"""95th percentile of the router's per-request wait from submit to its wave's flush (obs.trace samples), in ms."""
from portbench.lib import program_spans


def read(obs):
    return program_spans.sample_p95(obs, "router.queue_wait_ms")
