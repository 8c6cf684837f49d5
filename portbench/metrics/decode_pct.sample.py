"""The VAE decode's share of a request's time on the device, in percent."""
from portbench import readers


def read(trace):
    return readers.stage_pct(trace, "decode")
