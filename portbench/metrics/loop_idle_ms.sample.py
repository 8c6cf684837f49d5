"""Device idle milliseconds a request while the host is inside the sampler's
loop (``sample`` and the spans under it)."""
from portbench import spans


def read(trace):
    return spans.idle_ms(trace, ("sample",))
