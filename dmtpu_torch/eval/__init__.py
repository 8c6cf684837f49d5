"""Evaluation: FID / IS / KID with features on the card (classic Inception-FID
and CLIP-FID); counterpart of ``dmtpu/eval``."""
from dmtpu_torch.eval.fid import (
    CLIPFeatureExtractor,
    compute_fid,
    compute_statistics,
    fid_from_features,
    frechet_distance,
    inception_score,
)
from dmtpu_torch.eval.inception import (
    FIDInceptionV3,
    InceptionFeatureExtractor,
    convert_inception_checkpoint,
)

__all__ = [
    "inception_score",
    "compute_statistics",
    "frechet_distance",
    "fid_from_features",
    "compute_fid",
    "CLIPFeatureExtractor",
    "FIDInceptionV3",
    "InceptionFeatureExtractor",
    "convert_inception_checkpoint",
]
