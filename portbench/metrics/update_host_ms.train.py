"""Host milliseconds a step inside the optimizer's step and the EMA update
(the program's ``train.optimizer`` and ``train.ema`` spans, card-only
traced steps)."""
from portbench import spans


def read(trace):
    return spans.host_ms(trace, ("train.optimizer", "train.ema"))
