"""Device idle milliseconds a step while the host is inside the clip, the
optimizer or the EMA (``train.clip``, ``train.optimizer``, ``train.ema``)."""
from portbench import spans


def read(trace):
    return spans.idle_ms(trace, ("train.clip", "train.optimizer", "train.ema"))
