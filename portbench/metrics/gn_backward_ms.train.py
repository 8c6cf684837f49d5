"""Device milliseconds a step under the GroupNorm backward."""
from portbench import readers


def read(trace):
    return readers.device_ms_under(trace, "GroupNormSiLU.backward")
