"""Device idle milliseconds a step while the host is inside the forward or
the backward (``train.forward``, ``train.backward`` and the spans under them)."""
from portbench import spans


def read(trace):
    return spans.idle_ms(trace, ("train.forward", "train.backward"))
