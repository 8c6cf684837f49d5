"""Parameter conversion: JAX-package params into the port, and the key
surgery on upstream Stable Diffusion and SD3 state dicts."""
from dmtpu_torch.convert.flax_bridge import (
    load_flax_params,
    mmdit_key,
    sdxl_state_dict_from_flax,
    state_dict_from_flax,
    torch_name,
)
from dmtpu_torch.convert.sd import (
    diffusers_vae_to_compvis,
    hf_clip_text_strip,
    openclip_text_to_hf,
    split_sd_checkpoint,
    split_sdxl_checkpoint,
)
from dmtpu_torch.convert.zoo import convert_mmdit, convert_sd3_vae

__all__ = ["load_flax_params", "mmdit_key", "sdxl_state_dict_from_flax", "state_dict_from_flax",
           "torch_name", "diffusers_vae_to_compvis", "hf_clip_text_strip", "openclip_text_to_hf",
           "split_sd_checkpoint", "split_sdxl_checkpoint", "convert_mmdit", "convert_sd3_vae"]
