"""Stable Diffusion text-to-image page (counterpart of the JAX package's
``streamlit/pages/3_Stable_Diffusion.py``): widgets over
``dmtpu_torch/ui/sd.py``.

DMTPU_SD_CONFIG (an SD weight yaml), DMTPU_SD_WEIGHTS (``.ckpt`` /
``.safetensors`` / a merged-LoRA file), DMTPU_CLIP_TOKENIZER (a local
CLIPTokenizer directory), optionally DMTPU_SD_WEIGHTS_DIR (a Model dropdown)
and DMTPU_DEVICE (default ``cuda``).  Without weights the page runs with
random weights (demo mode).
"""
import os
import sys

# streamlit runs a page as a script: the repository's root onto the path
sys.path.append(os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))))

import numpy as np  # noqa: E402
import streamlit as st  # noqa: E402

from dmtpu_torch.ui import sd as sd_ui  # noqa: E402
from dmtpu_torch.utils.image import to_pil  # noqa: E402
from dmtpu_torch.utils.misc import list_weight_files  # noqa: E402

CONFIG = os.environ.get("DMTPU_SD_CONFIG", "weights/stablediffusion/v1-inference.yaml")
WEIGHTS = os.environ.get("DMTPU_SD_WEIGHTS")
WEIGHTS_DIR = os.environ.get("DMTPU_SD_WEIGHTS_DIR")
TOKENIZER = os.environ.get("DMTPU_CLIP_TOKENIZER")
DEVICE = os.environ.get("DMTPU_DEVICE", "cuda")


@st.cache_resource(max_entries=1)  # one resident model
def load_sd(weights_path=None):
    weights = weights_path or WEIGHTS
    if not weights:
        st.warning("DMTPU_SD_WEIGHTS not set — running with RANDOM weights (demo mode)")
    conf, sd = sd_ui.load_sd(CONFIG, weights, TOKENIZER, DEVICE)
    return conf, sd, bool(weights)


st.title("Stable Diffusion")
weights_choice = None
if WEIGHTS_DIR:
    _found = list_weight_files(WEIGHTS_DIR)
    weights_choice = _found and st.selectbox("Model", options=_found) or None
prompt = st.text_area("Prompt", "a photograph of an astronaut riding a horse")
negative = st.text_area("Negative prompt", "")
sampler = st.selectbox("Sampler", list(sd_ui.SAMPLERS))
steps = st.slider("Steps", 5, 200, 50)
scale = st.slider("CFG scale", 1.0, 20.0, 7.5)
height = st.select_slider("Height", options=list(range(128, 1025, 128)), value=512)
width = st.select_slider("Width", options=list(range(128, 1025, 128)), value=512)
offset_noise = st.slider("Offset noise", 0.0, 0.2, 0.0)
tome_ratio = st.slider(
    "Token merging (ToMe) ratio", 0.0, 0.75, 0.0, step=0.05,
    help="merge the most redundant self-attention tokens at the full-res "
         "level (dmtpu_torch/ops/tome.py) — ~1.3-1.5x faster at 0.5, near-baseline quality")
freeu = st.checkbox(
    "FreeU", value=False,
    help="training-free backbone/skip re-weighting at the two deepest "
         "decoder stages (dmtpu_torch/ops/freeu.py, SD1.5 paper settings)")
batch_size = st.slider("Batch size", 1, 8, 1)
batch_count = st.slider("Batch count", 1, 8, 1)
respace_type = st.selectbox("Respace type", list(sd_ui.RESPACE_TYPES))
seed = st.number_input("Seed", value=-1, min_value=-1, max_value=2**32 - 1,
                       help="-1 draws a fresh random seed per run (reference :160-162)")
if seed == -1:
    seed = int(np.random.default_rng().integers(0, 2**32, dtype=np.uint32))

if st.button("Generate"):
    conf, sd, real_weights = load_sd(weights_choice)
    images = sd_ui.generate_sd(
        conf, sd, prompt, negative, sampler=sampler, steps=steps, scale=scale, height=height,
        width=width, offset_noise=offset_noise, tome_ratio=tome_ratio, freeu=freeu,
        batch_size=batch_size, batch_count=batch_count, respace_type=respace_type,
        seed=int(seed), real_weights=real_weights, device=DEVICE)
    for image in images.permute(0, 2, 3, 1).cpu().numpy():
        st.image(to_pil(image), width=width)
