"""Share of the ``sample`` spans' device extent outside their ``denoiser``
calls (the sampler's own work and the gaps between calls), in percent."""
from portbench import spans


def read(trace):
    inside = spans.device_pct(trace, ("denoiser",), "sample")
    return None if inside is None else 100.0 - inside
