"""Host ms of the MetricCollection `forward` spans (obs.trace, unfenced) per epoch of the window."""


def read(obs):
    return obs.get("forward_host_ms_per_epoch")
