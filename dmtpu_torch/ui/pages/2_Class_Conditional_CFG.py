"""Class-conditional CFG page (counterpart of the JAX package's
``streamlit/pages/2_Class_Conditional_CFG.py``): widgets over
``dmtpu_torch/ui/cfg.py``.

DMTPU_CONFIG (a class-conditional pixel-space config), DMTPU_WEIGHTS,
optionally DMTPU_WEIGHTS_DIR and DMTPU_DEVICE (default ``cuda``).
"""
import math
import os
import sys

# streamlit runs a page as a script: the repository's root onto the path
sys.path.append(os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))))

import numpy as np  # noqa: E402
import streamlit as st  # noqa: E402

from dmtpu_torch.ui import cfg, uncond  # noqa: E402
from dmtpu_torch.utils.image import make_grid, to_pil  # noqa: E402
from dmtpu_torch.utils.misc import list_weight_files  # noqa: E402

CONFIG = os.environ.get("DMTPU_CONFIG", "configs/ddpm_cfg_cifar10.yaml")
WEIGHTS = os.environ.get("DMTPU_WEIGHTS")
WEIGHTS_DIR = os.environ.get("DMTPU_WEIGHTS_DIR")
DEVICE = os.environ.get("DMTPU_DEVICE", "cuda")


@st.cache_resource(max_entries=1)  # one resident model
def load_model(weights_path=None):
    return uncond.load_pixel_model(CONFIG, weights_path or WEIGHTS, DEVICE)


st.title("Class-conditional Generation (CFG)")
weights_choice = None
if WEIGHTS_DIR:
    _found = list_weight_files(WEIGHTS_DIR)
    weights_choice = _found and st.selectbox("Model", options=_found) or None
sampler = st.selectbox("Sampler", list(cfg.PAGE_SAMPLERS))
steps = st.slider("Sampling steps", 5, 1000, 50)
scale = st.slider("Guidance scale", 0.0, 10.0, 3.0)
cls = st.number_input("Class id", value=0)
var_type = st.selectbox("Variance", list(cfg.PAGE_VAR_TYPES))
respace_type = st.selectbox("Respace type", list(uncond.EPS_RESPACE_TYPES))
n = st.slider("Batch size", 1, 64, 16)
batch_count = st.slider("Batch count", 1, 8, 1)
seed = st.number_input("Seed", value=-1, min_value=-1, max_value=2**32 - 1,
                       help="-1 draws a fresh random seed per run")
if seed == -1:
    seed = int(np.random.default_rng().integers(0, 2**32, dtype=np.uint32))

if st.button("Sample"):
    conf, model = load_model(weights_choice)
    images = cfg.generate_cfg(
        conf, model, int(cls), sampler=sampler, steps=steps, scale=scale, var_type=var_type,
        respace_type=respace_type, n=n, batch_count=batch_count, seed=int(seed),
        device=DEVICE).permute(0, 2, 3, 1).cpu().numpy()
    for i in range(batch_count):
        st.image(to_pil(make_grid(images[i * n:(i + 1) * n], nrow=int(math.ceil(math.sqrt(n))))),
                 width=512)
