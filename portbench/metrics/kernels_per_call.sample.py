"""Device kernels a denoiser call in the traced requests."""
from portbench import readers


def read(trace):
    return readers.kernels_per_call(trace)
