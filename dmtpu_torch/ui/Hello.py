"""The port's Streamlit entry page (counterpart of the JAX package's
``streamlit/Hello.py``).

    streamlit run dmtpu_torch/ui/Hello.py

``streamlit`` is not a dependency of the port: the pages run where it is
installed.  Each page is a widget layer over a module of ``dmtpu_torch/ui``.
"""
import streamlit as st

st.set_page_config(page_title="dmtpu", page_icon="🌀")
st.title("dmtpu — diffusion sampling")
st.markdown(
    """
Select a page from the sidebar:

1. **Unconditional Image Generation** — any sampler / variance / respacing
2. **Class-conditional (CFG)** — guidance-scale controlled sampling
3. **Stable Diffusion** — text-to-image with positive/negative prompts
4. **Stable Diffusion XL** — text-to-image at 1024x1024

Configure checkpoints via environment variables (see each page); the pages
run on the card unless ``DMTPU_DEVICE=cpu``.
"""
)
