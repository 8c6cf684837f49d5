"""Mean device milliseconds of a denoiser call (the program's ``denoiser``
span, CUDA events at its ends) in the traced requests."""
from portbench import spans


def read(trace):
    return spans.device_ms_mean(trace, "denoiser")
