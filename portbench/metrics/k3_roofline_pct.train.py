"""K3 (GroupNorm+SiLU) at its roofline in the traced steps, in percent."""
from portbench import readers


def read(trace):
    return readers.kernel_roofline_pct(trace, "k3")
