"""100 less the device's busy share of the traced window, in %."""
from portbench.lib.readers import idle_pct


def read(obs):
    return idle_pct(obs)
