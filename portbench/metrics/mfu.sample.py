"""Operations of the whole requests over the window's time and the bf16 peak, in percent."""
from portbench import readers


def read(trace):
    return readers.mfu(trace)
