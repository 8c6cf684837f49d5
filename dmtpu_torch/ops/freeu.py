"""FreeU: training-free re-weighting of a diffusion UNet's decoder, in NCHW.

Counterpart of ``dmtpu/ops/freeu.py`` (Si et al., "FreeU: Free Lunch in
Diffusion U-Net", CVPR 2024).  At the two deepest decoder stages it scales
the first half of the backbone's channels up and damps the low-frequency
band of the skip connection.  Four scalars (b1, b2, s1, s2), no parameters.
The spectral filter is an FFT over (H, W) in f32 (``torch.fft``); the output
is cast back to the input's dtype.
"""
from __future__ import annotations

import torch

# the paper's settings (backbone b1 / b2, skip s1 / s2)
SD15_DEFAULTS = (1.5, 1.6, 0.9, 0.2)
SD21_DEFAULTS = (1.4, 1.6, 0.9, 0.2)
SDXL_DEFAULTS = (1.3, 1.4, 0.9, 0.2)

_HW = (-2, -1)


def fourier_filter(x: torch.Tensor, threshold: int, scale: float) -> torch.Tensor:
    """Scale the centred low-frequency box of an NCHW feature map: FFT over
    (H, W), DC shifted to the centre, the ``2*threshold`` square around it
    multiplied by ``scale``, shifted back and inverted.  The result has
    ``x``'s dtype and memory format (a channels-last skip stays so for the
    concat and the convolution after it)."""
    xf = torch.fft.fftshift(torch.fft.fftn(x.float(), dim=_HW), dim=_HW)
    h, w = x.shape[-2:]
    ch, cw = h // 2, w // 2
    mask = torch.ones((h, w), device=x.device)
    mask[ch - threshold:ch + threshold, cw - threshold:cw + threshold] = scale
    xf = torch.fft.ifftshift(xf * mask, dim=_HW)
    return torch.empty_like(x).copy_(torch.fft.ifftn(xf, dim=_HW).real)


def apply_freeu(h: torch.Tensor, skip: torch.Tensor, model_channels: int,
                b1: float, b2: float, s1: float, s2: float):
    """The FreeU gate at one decoder concat site (NCHW): backbone ``h`` with
    4 * ``model_channels`` channels gets ``b1`` on its first half and the
    skip the filter with ``s1``; 2 * ``model_channels``: ``b2`` and ``s2``.
    Other sites pass through.  Returns ``(h, skip)``."""
    c = h.shape[1]
    if c == model_channels * 4:
        b, s, half = b1, s1, model_channels * 2
    elif c == model_channels * 2:
        b, s, half = b2, s2, model_channels
    else:
        return h, skip
    h = torch.cat([h[:, :half] * b, h[:, half:]], dim=1)
    return h, fourier_filter(skip, 1, s)
