"""95th percentile of how late each request was sent behind its due time, in ms."""
from portbench.lib.readers import p95


def read(obs):
    return p95(obs.get("late_ms", []))
