"""Unconditional sampling page (counterpart of the JAX package's
``streamlit/pages/1_Unconditional_Image_Generation.py``): widgets over
``dmtpu_torch/ui/uncond.py``.

DMTPU_CONFIG (a pixel-space config), DMTPU_WEIGHTS (a torch file or the JAX
package's ``.npz``), optionally DMTPU_WEIGHTS_DIR (scanned into a Model
dropdown) and DMTPU_DEVICE (default ``cuda``).
"""
import math
import os
import sys
import time

# streamlit runs a page as a script: the repository's root onto the path
sys.path.append(os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))))

import numpy as np  # noqa: E402
import streamlit as st  # noqa: E402
import torch  # noqa: E402

from dmtpu_torch.ui import uncond  # noqa: E402
from dmtpu_torch.utils.image import make_grid, to_pil  # noqa: E402
from dmtpu_torch.utils.misc import list_weight_files  # noqa: E402

CONFIG = os.environ.get("DMTPU_CONFIG", "configs/ddpm_cifar10.yaml")
WEIGHTS = os.environ.get("DMTPU_WEIGHTS")
WEIGHTS_DIR = os.environ.get("DMTPU_WEIGHTS_DIR")
DEVICE = os.environ.get("DMTPU_DEVICE", "cuda")


@st.cache_resource(max_entries=1)  # streamlit reruns the page per widget
def _load_conf():
    return uncond.as_config(CONFIG)


# the sampler family of the config's diffusion target (ui/uncond.py)
try:
    CONF = _load_conf()
except Exception as e:  # a bad DMTPU_CONFIG: a UI error beats a raw traceback
    st.error(f"cannot read config {CONFIG!r}: {e}")
    st.stop()
    raise


@st.cache_resource(max_entries=1)  # one resident model
def load_model(weights_path=None):
    return uncond.load_pixel_model(CONFIG, weights_path or WEIGHTS, DEVICE)


st.title("Unconditional Image Generation")
weights_choice = None
if WEIGHTS_DIR:
    _found = list_weight_files(WEIGHTS_DIR)
    weights_choice = _found and st.selectbox("Model", options=_found) or None
sampler = st.selectbox("Sampler", list(uncond.sampler_names(CONF)))
steps = st.slider("Sampling steps", 5, 1000, 50)
var_type = st.selectbox("Variance", list(uncond.VAR_TYPES))
respace_type = st.selectbox("Respace type", list(uncond.respace_types(CONF)))
n = st.slider("Batch size", 1, 64, 16)
batch_count = st.slider("Batch count", 1, 8, 1)
seed = st.number_input("Seed", value=-1, min_value=-1, max_value=2**32 - 1,
                       help="-1 draws a fresh random seed per run")
if seed == -1:
    seed = int(np.random.default_rng().integers(0, 2**32, dtype=np.uint32))

if st.button("Sample"):
    conf, model = load_model(weights_choice)
    t0 = time.time()
    images = uncond.generate_uncond(
        conf, model, sampler=sampler, steps=steps, var_type=var_type,
        respace_type=respace_type, n=n, batch_count=batch_count, seed=int(seed),
        device=DEVICE).permute(0, 2, 3, 1).cpu().numpy()
    for i in range(batch_count):
        st.image(to_pil(make_grid(images[i * n:(i + 1) * n], nrow=int(math.ceil(math.sqrt(n))))),
                 width=512)
    where = next(model.parameters()).device
    name = torch.cuda.get_device_name(where) if where.type == "cuda" else "cpu"
    st.caption(f"{n * batch_count} samples in {time.time() - t0:.2f}s on {name}")
