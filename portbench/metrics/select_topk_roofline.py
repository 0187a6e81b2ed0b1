"""select_topk: the least time of its calls (bytes at the HBM rate) over its kernels' device time, in %."""
from portbench.lib.readers import kernel_roofline
from portbench.lib.roofline import TOPK_KERNELS


def read(obs):
    return kernel_roofline(obs, "select_topk", TOPK_KERNELS)
