"""Attention and GroupNorm ops; each CUDA kernel beside its plain version."""
from dmtpu_torch.ops.attention import attention, mha
from dmtpu_torch.ops.dispatch import plain_ops
from dmtpu_torch.ops.flash_attention import (
    flash_attention_backward_reference,
    flash_attention_bwd,
    flash_attention_fwd,
    flash_attention_reference,
)
from dmtpu_torch.ops.groupnorm import group_norm, group_norm_silu, group_norm_silu_reference

__all__ = ["attention", "mha", "plain_ops", "flash_attention_backward_reference",
           "flash_attention_bwd", "flash_attention_fwd", "flash_attention_reference",
           "group_norm", "group_norm_silu", "group_norm_silu_reference"]
