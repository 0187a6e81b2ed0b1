"""% of the traced window idle on the device while the host is inside a metrics_tpu_torch.* range."""
from portbench.lib import program_spans


def read(obs):
    return program_spans.from_profile(obs, program_spans.idle_in_program_pct)
