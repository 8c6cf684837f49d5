"""Megabytes (1e6 bytes) of compute-dtype copies of parameters a denoiser
call (the program's ``weight_cast_bytes`` count under ``denoiser``)."""
from portbench import spans


def read(trace):
    n = spans.count_per_span(trace, "weight_cast_bytes", "denoiser")
    return None if n is None else n / 1e6
