"""FID / Inception Score / KID evaluation of two image directories.

    python -m dmtpu_torch.scripts.evaluate --real_dir DIR --fake_dir DIR \\
        [--inception_weights pt_inception-2015-12-05-52768-1.pth]   # classic FID + IS
        [--clip_pretrained /local/clip]                              # CLIP-FID
        [--kid] [--device cuda|cpu]

Counterpart of ``scripts/evaluate.py`` (the reference computes FID / IS with
torch-fidelity on 50K samples; reference: docs/DDPM.md "Evaluation"), with
the same flags, defaults and refusals, plus ``--device`` (default ``cuda``:
without a card the CLI fails unless ``--device cpu`` is given).  With
``--inception_weights`` (the standard pt_inception file, supplied locally):
classic FID on the pool3 features and IS on the 1008-way logits, comparable
with the reference's published tables (``BASELINE.md``), and KID on the same
features with ``--kid``.  With ``--clip_pretrained`` (a local
``transformers`` CLIP directory with torch weights): CLIP-FID.  Prints one
JSON line: ``kid_*`` at full precision, the rest to 4 places.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence

import numpy as np

from dmtpu_torch.eval import (
    CLIPFeatureExtractor,
    InceptionFeatureExtractor,
    compute_fid,
    fid_from_features,
    inception_score,
)
from dmtpu_torch.eval.fid import kid_from_features
from dmtpu_torch.scripts.sample_sd import resolve_device
from dmtpu_torch.utils.logger import get_logger


def load_images_u8(path: str, img_size: Optional[int] = None, limit: int = 0) -> np.ndarray:
    """Directory of images -> uint8 NHWC array.

    ``img_size=None`` (default) keeps the NATIVE resolution of the first
    image (stragglers are resized to it, bicubic), as torch-fidelity feeds
    full-resolution images and lets the Inception pipeline do the 299²
    resize.  An explicit ``img_size`` force-resizes everything.
    """
    from PIL import Image

    files = []
    for root, _, names in os.walk(path):
        files += [os.path.join(root, n) for n in names
                  if n.lower().endswith((".png", ".jpg", ".jpeg", ".webp"))]
    files.sort()
    if limit:
        files = files[:limit]
    if not files:
        raise FileNotFoundError(f"no images under {path}")
    size = (img_size, img_size) if img_size else None
    ims = []
    for f in files:
        im = Image.open(f).convert("RGB")
        if size is None:
            size = im.size  # native (w, h) of the first image
        if im.size != size:
            im = im.resize(size, Image.BICUBIC)
        ims.append(np.asarray(im))
    return np.stack(ims)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--real_dir", required=True)
    p.add_argument("--fake_dir", required=True)
    p.add_argument("--img_size", type=int, default=None,
                   help="force-resize images before extraction "
                        "(default: keep native resolution, like torch-fidelity)")
    p.add_argument("--n_max", type=int, default=0, help="cap images per side (0 = all)")
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--inception_weights", default=None,
                   help="local pt_inception-2015-12-05 .pth -> classic FID + IS")
    p.add_argument("--clip_pretrained", default=None,
                   help="local HF CLIP checkpoint -> CLIP-FID")
    p.add_argument("--is_splits", type=int, default=10)
    p.add_argument("--kid", action="store_true",
                   help="also report KID (unbiased polynomial MMD^2, "
                        "torch-fidelity procedure) on the Inception features")
    p.add_argument("--kid_subsets", type=int, default=100)
    p.add_argument("--kid_subset_size", type=int, default=1000)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    return p


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the evaluation, print its JSON line and return the results."""
    p = build_parser()
    args = p.parse_args(argv)
    logger = get_logger()

    if not args.inception_weights and not args.clip_pretrained:
        p.error("provide --inception_weights (classic FID/IS) and/or --clip_pretrained (CLIP-FID)")
    if args.kid and not args.inception_weights:
        p.error("--kid computes KID on Inception pool3 features; it needs --inception_weights")
    try:
        device = resolve_device(args.device, cli="evaluate")
    except RuntimeError as e:
        raise SystemExit(str(e)) from None

    real = load_images_u8(args.real_dir, args.img_size, args.n_max)
    fake = load_images_u8(args.fake_dir, args.img_size, args.n_max)
    logger.info(f"real: {real.shape}  fake: {fake.shape}")

    results = {}
    if args.inception_weights:
        ext = InceptionFeatureExtractor(args.inception_weights, batch_size=args.batch_size,
                                        device=device)
        # one network sweep per image set: FID uses pool3, IS the probabilities
        # of the same fake-set sweep, KID the same features
        fake_pool3, fake_probs = ext.features_and_probs(fake)
        real_pool3 = ext(real)
        results["fid"] = fid_from_features(real_pool3, fake_pool3)
        results["is_mean"], results["is_std"] = inception_score(fake_probs,
                                                                splits=args.is_splits)
        if args.kid:
            results["kid_mean"], results["kid_std"] = kid_from_features(
                real_pool3, fake_pool3, subsets=args.kid_subsets,
                subset_size=args.kid_subset_size)
    if args.clip_pretrained:
        ext = CLIPFeatureExtractor(args.clip_pretrained, batch_size=args.batch_size,
                                   device=device)
        results["clip_fid"] = compute_fid(real, fake, ext)

    # KID magnitudes are ~1e-3/1e-4 — full precision for those, 4 dp for the rest
    print(json.dumps({k: (float(v) if k.startswith("kid") else round(float(v), 4))
                      for k, v in results.items()}))
    return results


if __name__ == "__main__":
    main()
