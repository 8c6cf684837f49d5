"""FID, KID and IS: the statistics on the host in float64, the features on the card.

Counterpart of ``dmtpu/eval/fid.py``.  The reference computes FID / IS with
torch-fidelity on 50K samples (reference: docs/DDPM.md "Evaluation").  The
numpy functions are the JAX package's, copied (that module's host functions
import no JAX, but the port imports nothing of it): the same features give
the same FID, KID and IS.  One change: ``frechet_distance`` calls
``scipy.linalg.sqrtm`` without ``disp``, which SciPy deprecates (1.17) and
drops (1.18); the square root, the finiteness check with its ``eps`` offset
retry and the ``.real`` step are as they were.

Extractors are ``f(images_uint8_nhwc) -> [N, D]``:
  - ``CLIPFeatureExtractor``: CLIP-FID (Kynkäänniemi et al. 2022) through
    ``transformers``' torch ``CLIPModel`` from a local directory;
  - ``dmtpu_torch.eval.inception.InceptionFeatureExtractor``: classic
    Inception-FID from the pt_inception-2015-12-05 weights, supplied locally;
  - any callable of the same form.
"""
from __future__ import annotations

from typing import Any, Callable, Iterable, Optional, Tuple

import numpy as np
import torch

from dmtpu_torch.diffusions.guidance.clip_guidance import (
    _CLIP_MEAN,
    _CLIP_STD,
    _bilinear,
    _projected,
)
from dmtpu_torch.scripts.sample_sd import resolve_device


def compute_statistics(features: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(mu, sigma) of a feature matrix [N, D] in float64."""
    f = np.asarray(features, np.float64)
    mu = f.mean(axis=0)
    sigma = np.cov(f, rowvar=False)
    return mu, sigma


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """Fréchet distance between two Gaussians (the FID formula)."""
    from scipy import linalg

    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2
    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean))


def fid_from_features(feats1: np.ndarray, feats2: np.ndarray) -> float:
    m1, s1 = compute_statistics(feats1)
    m2, s2 = compute_statistics(feats2)
    return frechet_distance(m1, s1, m2, s2)


class CLIPFeatureExtractor:
    """CLIP image-tower features for CLIP-FID, unit length, f32.

    Built from a LOCAL ``transformers`` CLIP directory (torch weights), loaded
    onto ``device`` (default the card), or from an injected ``module`` with
    ``get_image_features(pixel_values=)`` (a ``CLIPModel``).  Preprocessing
    as the JAX extractor's: uint8 NHWC -> /255 -> bilinear resize to
    ``image_size``² (antialiased, as ``jax.image.resize``) -> CLIP's mean /
    std."""

    def __init__(self, clip_pretrained: Optional[str] = None, module: Any = None,
                 image_size: int = 224, batch_size: int = 256, device: Any = "cuda"):
        self.device = resolve_device(device, cli="CLIPFeatureExtractor")
        if module is None:
            try:
                from transformers import CLIPModel
            except ImportError as e:
                raise ImportError("CLIPFeatureExtractor with `clip_pretrained` needs the "
                                  "`transformers` package (torch CLIPModel)") from e
            # attention as plain tensor ops, as the JAX package's FlaxCLIPModel runs it
            module = CLIPModel.from_pretrained(clip_pretrained, attn_implementation="eager")
        self.module = module.float().eval().requires_grad_(False).to(self.device)
        self.image_size = image_size
        self.batch_size = batch_size
        self._mean = torch.tensor(_CLIP_MEAN, device=self.device).view(1, 3, 1, 1)
        self._std = torch.tensor(_CLIP_STD, device=self.device).view(1, 3, 1, 1)

    @torch.no_grad()
    def _extract(self, batch_u8: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(batch_u8)).to(self.device)
        x = x.permute(0, 3, 1, 2).float() / 255.0
        x = _bilinear(x, (self.image_size, self.image_size))
        x = (x - self._mean) / self._std
        feats = _projected(self.module.get_image_features(pixel_values=x))
        return (feats / torch.linalg.norm(feats, dim=-1, keepdim=True)).cpu().numpy()

    def __call__(self, images_u8: np.ndarray) -> np.ndarray:
        return np.concatenate([self._extract(np.asarray(images_u8[i:i + self.batch_size]))
                               for i in range(0, len(images_u8), self.batch_size)])


def compute_fid(
    images1_u8: Iterable[np.ndarray],
    images2_u8: Iterable[np.ndarray],
    extractor: Callable[[np.ndarray], np.ndarray],
) -> float:
    """FID between two uint8 NHWC image sets via the given extractor."""
    f1 = extractor(np.asarray(images1_u8))
    f2 = extractor(np.asarray(images2_u8))
    return fid_from_features(f1, f2)


def polynomial_mmd2(f1: np.ndarray, f2: np.ndarray, degree: int = 3,
                    gamma: Optional[float] = None, coef0: float = 1.0) -> float:
    """Unbiased MMD² with the polynomial kernel k(x,y) = (γ x·y + c)^d —
    the KID kernel (Bińkowski et al. 2018, arXiv:1801.01401; defaults are
    torch-fidelity's: d=3, γ=1/dim, c=1)."""
    f1 = np.asarray(f1, np.float64)
    f2 = np.asarray(f2, np.float64)
    if len(f1) < 2 or len(f2) < 2:
        raise ValueError(
            f"unbiased MMD^2 needs >= 2 samples per set, got {len(f1)}/{len(f2)}")
    if gamma is None:
        gamma = 1.0 / f1.shape[1]
    kxx = (gamma * (f1 @ f1.T) + coef0) ** degree
    kyy = (gamma * (f2 @ f2.T) + coef0) ** degree
    kxy = (gamma * (f1 @ f2.T) + coef0) ** degree
    m, n = len(f1), len(f2)
    term_x = (kxx.sum() - np.trace(kxx)) / (m * (m - 1))
    term_y = (kyy.sum() - np.trace(kyy)) / (n * (n - 1))
    return float(term_x + term_y - 2.0 * kxy.mean())


def kid_from_features(feats1: np.ndarray, feats2: np.ndarray,
                      subsets: int = 100, subset_size: int = 1000,
                      seed: int = 0) -> Tuple[float, float]:
    """Kernel Inception Distance: mean ± std of unbiased polynomial MMD²
    over ``subsets`` random subsets of size ``subset_size`` (torch-fidelity
    procedure and defaults; subset size is clamped to the smaller set)."""
    feats1 = np.asarray(feats1)
    feats2 = np.asarray(feats2)
    rng = np.random.RandomState(seed)
    n = min(subset_size, len(feats1), len(feats2))
    vals = []
    for _ in range(subsets):
        a = feats1[rng.choice(len(feats1), n, replace=False)]
        b = feats2[rng.choice(len(feats2), n, replace=False)]
        vals.append(polynomial_mmd2(a, b))
    return float(np.mean(vals)), float(np.std(vals))


def inception_score(probs: np.ndarray, splits: int = 10) -> Tuple[float, float]:
    """Inception Score from class probabilities [N, K]: exp(E KL(p(y|x)||p(y))).

    The classifier producing ``probs`` is pluggable: the FID InceptionV3's
    1008-way head (``InceptionFeatureExtractor.classify``), or another one.
    """
    probs = np.asarray(probs, np.float64)
    n = len(probs)
    scores = []
    for i in range(splits):
        part = probs[i * n // splits:(i + 1) * n // splits]
        marginal = part.mean(axis=0, keepdims=True)
        kl = np.sum(part * (np.log(part + 1e-16) - np.log(marginal + 1e-16)), axis=1)
        scores.append(float(np.exp(kl.mean())))
    return float(np.mean(scores)), float(np.std(scores))
