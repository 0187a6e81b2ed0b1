"""Synchronizing CUDA runtime calls inside the program's metrics_tpu_torch.* ranges, per collection forward."""
from portbench.lib import program_spans


def read(obs):
    return program_spans.from_profile(obs, program_spans.host_syncs_per_forward)
