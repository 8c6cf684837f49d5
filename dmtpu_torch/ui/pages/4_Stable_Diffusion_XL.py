"""Stable Diffusion XL text-to-image page (counterpart of the JAX package's
``streamlit/pages/4_Stable_Diffusion_XL.py``): widgets over
``dmtpu_torch/ui/sdxl.py``.

DMTPU_SDXL_CONFIG (the sd_xl_base weight yaml), DMTPU_SDXL_WEIGHTS
(``.safetensors``), DMTPU_CLIP_TOKENIZER / DMTPU_OPENCLIP_TOKENIZER (local
tokenizer directories) and DMTPU_DEVICE (default ``cuda``).  Without weights
the page runs with random weights (demo mode).
"""
import os
import sys

# streamlit runs a page as a script: the repository's root onto the path
sys.path.append(os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))))

import numpy as np  # noqa: E402
import streamlit as st  # noqa: E402

from dmtpu_torch.ui import sdxl  # noqa: E402
from dmtpu_torch.utils.image import to_pil  # noqa: E402

CONFIG = os.environ.get("DMTPU_SDXL_CONFIG", "weights/sdxl/sd_xl_base.yaml")
WEIGHTS = os.environ.get("DMTPU_SDXL_WEIGHTS")
TOKENIZER_L = os.environ.get("DMTPU_CLIP_TOKENIZER")
TOKENIZER_G = os.environ.get("DMTPU_OPENCLIP_TOKENIZER", TOKENIZER_L)
DEVICE = os.environ.get("DMTPU_DEVICE", "cuda")


@st.cache_resource(max_entries=1)  # one resident model
def load_sdxl():
    if not WEIGHTS:
        st.warning("DMTPU_SDXL_WEIGHTS not set — running with RANDOM weights (demo mode)")
    conf, model = sdxl.load_sdxl(CONFIG, WEIGHTS, DEVICE)
    from transformers import CLIPTokenizer

    tokenizers = (CLIPTokenizer.from_pretrained(TOKENIZER_L),
                  CLIPTokenizer.from_pretrained(TOKENIZER_G))
    return conf, model, tokenizers


st.title("Stable Diffusion XL")
prompt = st.text_area("Prompt", "a professional photograph of an astronaut riding a horse")
negative = st.text_area("Negative prompt", "")
sampler = st.selectbox("Sampler", list(sdxl.SAMPLERS), index=0)
steps = st.slider("Steps", 5, 200, 50)
scale = st.slider("CFG scale", 1.0, 20.0, 5.0)
height = st.select_slider("Height", options=list(range(512, 1537, 128)), value=1024)
width = st.select_slider("Width", options=list(range(512, 1537, 128)), value=1024)
offset_noise = st.slider("Offset noise", 0.0, 0.2, 0.0)
batch_size = st.slider("Batch size", 1, 4, 1)
batch_count = st.slider("Batch count", 1, 8, 1)
respace_type = st.selectbox(
    "Respace type", ["uniform-linspace", "uniform-leading", "uniform-trailing"])
seed = st.number_input("Seed", value=-1, min_value=-1, max_value=2**32 - 1,
                       help="-1 draws a fresh random seed per run")
if seed == -1:
    seed = int(np.random.default_rng().integers(0, 2**32, dtype=np.uint32))

if st.button("Generate"):
    conf, model, tokenizers = load_sdxl()
    images, _ = sdxl.generate_sdxl(
        conf, model, prompt, negative, tokenizers=tokenizers, sampler=sampler, steps=steps,
        scale=scale, height=height, width=width, offset_noise=offset_noise,
        batch_size=batch_size, batch_count=batch_count, respace_type=respace_type,
        seed=int(seed), device=DEVICE)
    for image in images.permute(0, 2, 3, 1).cpu().numpy():
        st.image(to_pil(image), width=width)
