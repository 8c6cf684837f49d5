"""Share of the train steps' device extent in the frozen encoders
(``vae.encode`` and ``text_encode`` under ``train.step``), in percent."""
from portbench import spans


def read(trace):
    return spans.device_pct(trace, ("vae.encode", "text_encode"), "train.step")
