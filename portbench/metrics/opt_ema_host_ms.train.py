"""Host milliseconds a step in the optimizer's step and the EMA update (the
benchmark times both calls in the untraced window)."""
from portbench import readers


def read(trace):
    return readers.host_ms(trace, "optimizer.step", "ema.update")
