"""Share of the traced steps in which the device ran nothing, in percent."""
from portbench import readers


def read(trace):
    return readers.idle_pct(trace)
