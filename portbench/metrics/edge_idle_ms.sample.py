"""Device idle milliseconds a request while the host is inside the request
but outside the sampler's loop (text encode, decode, the copy to the host)."""
from portbench import spans


def read(trace):
    return spans.idle_ms(trace, ("request",), outside=("sample",))
