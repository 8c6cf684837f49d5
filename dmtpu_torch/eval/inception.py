"""The FID InceptionV3 (pt_inception-2015-12-05), NCHW.

Counterpart of ``dmtpu/eval/inception.py``.  The reference evaluates FID / IS
with torch-fidelity (reference: docs/DDPM.md "Evaluation"), whose feature
network is pytorch-fid's TF-ported InceptionV3: torchvision's graph with the
FID block variants (the branch average pools leave the padding out of the
count; ``Mixed_7c``'s pool branch is a max pool) and a 1008-way logits head.
The modules here carry the upstream key names (``Conv2d_1a_3x3.conv.weight``,
``Mixed_5b.branch1x1.bn.running_mean``, ``fc.weight``, ...), so the official
``pt_inception-2015-12-05-52768-1.pth`` loads as it is, through
``convert_inception_checkpoint``'s key check; the JAX package's variables
(``{"params", "batch_stats"}``) load through ``convert.load_flax_params``.

Every batch norm uses its running statistics (``FrozenBatchNorm2d``, eps
1e-3), as the JAX module's ``use_running_average=True`` does: ``.train()``
changes no feature and no buffer.  Inputs are resized to 299² by CLIP
guidance's bilinear resize, antialiased when it shrinks as
``jax.image.resize(..., "bilinear")`` is (without it the resize would
differ by up to 0.5 at 512 -> 299), and mapped to [-1, 1].  Outputs:
``pool3`` features [N, 2048] (FID) and logits [N, 1008] (IS).

``InceptionFeatureExtractor`` runs the network on the card in exact f32: the
convolutions go to cuDNN with TF32 off for its forward (the caller's flags
are put back afterwards), since FID is held to published numbers within 0.3
and the reference computed those in f32.
"""
from __future__ import annotations

import contextlib
import weakref
from typing import Any, Dict, Iterator, Mapping, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dmtpu_torch.diffusions.guidance.clip_guidance import _bilinear
from dmtpu_torch.scripts.sample_sd import resolve_device

Size = Union[int, Tuple[int, int]]
INPUT_SIZE = 299


class FrozenBatchNorm2d(nn.Module):
    """Batch norm with its running statistics always: ``weight``, ``bias``,
    ``running_mean`` and ``running_var`` under torch's names, no
    ``num_batches_tracked``, nothing updated in either mode."""

    def __init__(self, num_features: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            training=False, momentum=0.0, eps=self.eps)


class BasicConv2d(nn.Module):
    """conv (no bias) + frozen batch norm (eps 1e-3) + relu."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: Size,
                 stride: Size = 1, padding: Size = 0):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, kernel_size, stride=stride,
                              padding=padding, bias=False)
        self.bn = FrozenBatchNorm2d(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


def _avg_pool_nopad(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 average pool, pad 1, padding left out of the count (the
    FID variants' departure from stock torchvision)."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


def _max_pool(x: torch.Tensor, stride: int = 2, pad: int = 0) -> torch.Tensor:
    return F.max_pool2d(x, 3, stride=stride, padding=pad)


class InceptionA(nn.Module):
    def __init__(self, in_channels: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(in_channels, 64, 1)
        self.branch5x5_1 = BasicConv2d(in_channels, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(in_channels, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(in_channels, pool_features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3, self.branch_pool(_avg_pool_nopad(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, in_channels: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(in_channels, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(in_channels, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, _max_pool(x)], 1)


class InceptionC(nn.Module):
    def __init__(self, in_channels: int, channels_7x7: int):
        super().__init__()
        c7 = channels_7x7
        self.branch1x1 = BasicConv2d(in_channels, 192, 1)
        self.branch7x7_1 = BasicConv2d(in_channels, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(in_channels, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(in_channels, 192, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for conv in (self.branch7x7dbl_2, self.branch7x7dbl_3, self.branch7x7dbl_4,
                     self.branch7x7dbl_5):
            bd = conv(bd)
        return torch.cat([self.branch1x1(x), b7, bd, self.branch_pool(_avg_pool_nopad(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, in_channels: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(in_channels, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(in_channels, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for conv in (self.branch7x7x3_2, self.branch7x7x3_3, self.branch7x7x3_4):
            b7 = conv(b7)
        return torch.cat([b3, b7, _max_pool(x)], 1)


class InceptionE(nn.Module):
    """``pool`` "avg" (``Mixed_7b``: padding out of the count) or "max"
    (``Mixed_7c``: 3x3, stride 1, pad 1)."""

    def __init__(self, in_channels: int, pool: str = "avg"):
        super().__init__()
        if pool not in ("avg", "max"):
            raise ValueError(f"pool must be 'avg' or 'max', got {pool!r}")
        self.pool = pool
        self.branch1x1 = BasicConv2d(in_channels, 320, 1)
        self.branch3x3_1 = BasicConv2d(in_channels, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(in_channels, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(in_channels, 192, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        pooled = _avg_pool_nopad(x) if self.pool == "avg" else _max_pool(x, stride=1, pad=1)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(pooled)], 1)


class FIDInceptionV3(nn.Module):
    """The whole FID graph.  Input: floats in [0, 1], [N, 3, H, W], any H x W
    (resized to 299² when ``resize_input``); returns (pool3 [N, 2048],
    logits [N, 1008])."""

    def __init__(self, resize_input: bool = True, normalize_input: bool = True):
        super().__init__()
        self.resize_input = resize_input
        self.normalize_input = normalize_input  # [0, 1] -> [-1, 1] (the TF convention)
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, "avg")
        self.Mixed_7c = InceptionE(2048, "max")
        self.fc = nn.Linear(2048, 1008)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.resize_input and tuple(x.shape[2:]) != (INPUT_SIZE, INPUT_SIZE):
            x = _bilinear(x, (INPUT_SIZE, INPUT_SIZE))
        if self.normalize_input:
            x = 2.0 * x - 1.0
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(_max_pool(x)))
        x = _max_pool(x)
        for block in (self.Mixed_5b, self.Mixed_5c, self.Mixed_5d, self.Mixed_6a, self.Mixed_6b,
                      self.Mixed_6c, self.Mixed_6d, self.Mixed_6e, self.Mixed_7a, self.Mixed_7b,
                      self.Mixed_7c):
            x = block(x)
        pool3 = x.mean(dim=(2, 3))  # adaptive average pool to 1x1
        return pool3, self.fc(pool3)


def _module_keys() -> frozenset:
    with torch.device("meta"):
        return frozenset(FIDInceptionV3().state_dict())


def convert_inception_checkpoint(state_dict: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """An upstream pt_inception state dict (tensors or numpy arrays) checked
    against ``FIDInceptionV3``'s keys: ``num_batches_tracked`` is skipped, an
    unknown key raises ``ValueError``; values become f32 tensors in their
    own layout (the upstream keys are the module's)."""
    keys = _module_keys()
    out = {}
    for key, value in state_dict.items():
        if key.rpartition(".")[2] == "num_batches_tracked":
            continue
        if key not in keys:
            raise ValueError(f"unexpected inception key {key}")
        out[key] = torch.as_tensor(np.asarray(value), dtype=torch.float32)
    return out


@contextlib.contextmanager
def exact_f32() -> Iterator[None]:
    """TF32 off for cuDNN convolutions and cuBLAS matmuls within the block;
    the caller's flags are put back afterwards."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


class InceptionFeatureExtractor:
    """Classic Inception-FID extractor for ``dmtpu_torch.eval.fid``.

    ``weights_path``: a local pt_inception-2015-12-05 ``.pth``.
    ``__call__(images_u8)`` -> pool3 features [N, 2048] (FID);
    ``classify(images_u8)`` -> class probabilities [N, 1008] (IS); uint8
    NHWC numpy in, numpy out, ``batch_size`` images a forward on ``device``
    (default the card).
    """

    def __init__(self, weights_path: str, batch_size: int = 128, device: Any = "cuda"):
        from dmtpu_torch.scripts._common import load_torch_weights

        self.device = resolve_device(device, cli="InceptionFeatureExtractor")
        self.module = FIDInceptionV3().eval().requires_grad_(False)
        self.module.load_state_dict(convert_inception_checkpoint(load_torch_weights(weights_path)))
        self.module.to(self.device)
        self.batch_size = batch_size

    @torch.no_grad()
    def _run(self, batch_u8: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        x = torch.from_numpy(np.ascontiguousarray(batch_u8)).to(self.device)
        x = x.permute(0, 3, 1, 2).float() / 255.0
        with exact_f32():
            pool3, logits = self.module(x)
        return pool3.cpu().numpy(), torch.softmax(logits, dim=-1).cpu().numpy()

    def _batched(self, images_u8) -> Tuple[np.ndarray, np.ndarray]:
        # the last sweep is cached by the input's identity: __call__ then
        # classify on the same array (FID, then IS) runs the network once.  A
        # weak reference dies with the array, so a new object at a reused id
        # never matches, and a multi-GB image set is not kept alive.
        cached_ref, cached = getattr(self, "_sweep_cache", (None, None))
        if cached_ref is not None and cached_ref() is images_u8:
            return cached
        feats, probs = [], []
        for i in range(0, len(images_u8), self.batch_size):
            f, p = self._run(np.asarray(images_u8[i:i + self.batch_size]))
            feats.append(f)
            probs.append(p)
        out = (np.concatenate(feats), np.concatenate(probs))
        try:
            self._sweep_cache = (weakref.ref(images_u8), out)
        except TypeError:  # an object without weak references (a list)
            self._sweep_cache = (lambda a=images_u8: a, out)
        return out

    def features_and_probs(self, images_u8) -> Tuple[np.ndarray, np.ndarray]:
        """One sweep -> (pool3 [N, 2048], class probabilities [N, 1008])."""
        return self._batched(images_u8)

    def __call__(self, images_u8) -> np.ndarray:
        return self._batched(images_u8)[0]

    def classify(self, images_u8) -> np.ndarray:
        return self._batched(images_u8)[1]
