"""dmtpu_torch.eval.fid against dmtpu.eval.fid on the CPU.

The numpy functions are copies: on the same seeded features FID, KID, IS and
the statistics equal the JAX package's to 1e-10 (both run the same float64
numpy and SciPy code; only ``sqrtm``'s deprecated ``disp`` argument is gone,
and with it the ``DeprecationWarning``).  ``CLIPFeatureExtractor`` runs a
tiny CLIP whose random Flax weights are carried into ``transformers``' torch
``CLIPModel``, as ``tests/test_torch_ilvr_clip.py`` carries them; the two
extractors' unit-length features agree within 1e-5 absolute (two
frameworks' f32 transformers and resizes).
"""
import json
import os
import warnings

import numpy as np
import pytest
import torch

from dmtpu.eval import fid as jfid
from dmtpu_torch.eval import fid as tfid

TOL = 1e-10


def _features(seed, n, d, shift=0.0):
    rs = np.random.RandomState(seed)
    return (rs.randn(n, d) @ (np.eye(d) + 0.1 * rs.randn(d, d)) + shift).astype(np.float32)


@pytest.fixture(scope="module")
def feats():
    return _features(0, 300, 64), _features(1, 280, 64, shift=0.3)


def test_statistics_equal_jax(feats):
    for a, b in zip(tfid.compute_statistics(feats[0]), jfid.compute_statistics(feats[0])):
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL)


def test_fid_equals_jax_and_raises_no_deprecation_warning(feats):
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = tfid.fid_from_features(*feats)
    want = jfid.fid_from_features(*feats)
    assert got > 0 and abs(got - want) <= TOL * max(1.0, abs(want))


def test_frechet_distance_closed_form_and_identity():
    # two isotropic Gaussians in R^4: |mu1 - mu2|^2 + d (s1 - s2)^2
    got = tfid.frechet_distance(np.zeros(4), np.eye(4), np.full(4, 0.5), 4 * np.eye(4))
    assert abs(got - (4 * 0.25 + 4 * 1.0)) < 1e-10
    mu, sigma = tfid.compute_statistics(_features(2, 200, 16))
    assert abs(tfid.frechet_distance(mu, sigma, mu, sigma)) < 1e-8


@pytest.mark.parametrize("subsets,subset_size,seed", [(10, 100, 0), (4, 1000, 3)])
def test_kid_equals_jax_with_the_same_draws(feats, subsets, subset_size, seed):
    got = tfid.kid_from_features(*feats, subsets=subsets, subset_size=subset_size, seed=seed)
    want = jfid.kid_from_features(*feats, subsets=subsets, subset_size=subset_size, seed=seed)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    assert tfid.polynomial_mmd2(*feats) == pytest.approx(jfid.polynomial_mmd2(*feats),
                                                          rel=0, abs=TOL)
    with pytest.raises(ValueError, match="needs >= 2 samples"):
        tfid.polynomial_mmd2(feats[0][:1], feats[1])


@pytest.mark.parametrize("splits", [1, 10])
def test_inception_score_equals_jax(splits):
    rs = np.random.RandomState(4)
    logits = 3.0 * rs.randn(500, 1008)
    probs = np.exp(logits - logits.max(1, keepdims=True))
    probs /= probs.sum(1, keepdims=True)
    got = tfid.inception_score(probs.astype(np.float32), splits=splits)
    want = jfid.inception_score(probs.astype(np.float32), splits=splits)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    assert got[0] > 1.0


def test_compute_fid_runs_the_extractor_on_both_sets():
    rs = np.random.RandomState(5)
    a, b = (rs.randint(0, 256, (40, 4, 4, 3)).astype(np.uint8) for _ in range(2))

    def extractor(u8):
        return u8.reshape(len(u8), -1)[:, :8].astype(np.float64)

    assert tfid.compute_fid(a, b, extractor) == pytest.approx(
        jfid.compute_fid(a, b, extractor), rel=0, abs=TOL)


@pytest.fixture(scope="module")
def tiny_clip():
    """(the Flax CLIP module and params, the same weights in torch's
    CLIPModel): the tiny towers of ``tests/_tiny_fixtures.py::
    make_tiny_clip_dir``, random params drawn from the Flax model's shapes
    without its init."""
    from transformers import (
        CLIPConfig,
        CLIPModel,
        CLIPTextConfig,
        CLIPVisionConfig,
        FlaxCLIPModel,
    )
    from transformers.modeling_flax_pytorch_utils import load_flax_weights_in_pytorch_model

    text = CLIPTextConfig(vocab_size=256, hidden_size=32, intermediate_size=64,
                          num_hidden_layers=2, num_attention_heads=4,
                          max_position_embeddings=77, projection_dim=16)
    vision = CLIPVisionConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                              num_attention_heads=4, image_size=64, patch_size=16,
                              projection_dim=16)
    cfg = CLIPConfig(text_config=text.to_dict(), vision_config=vision.to_dict(),
                     projection_dim=16)
    flax_model = FlaxCLIPModel(cfg, _do_init=False)
    rs = np.random.RandomState(6)

    def fill(tree, name=""):
        if hasattr(tree, "items"):
            return {k: fill(v, k) for k, v in tree.items()}
        noise = np.asarray(rs.randn(*tree.shape), np.float32)
        if name == "kernel":
            return noise / np.sqrt(np.prod(tree.shape[:-1]))
        return (1.0 if name == "scale" else 0.0) + 0.05 * noise

    params = fill(flax_model.params_shape_tree)
    torch_model = CLIPModel(cfg)
    load_flax_weights_in_pytorch_model(torch_model, params)
    return flax_model.module, params, torch_model


@pytest.mark.parametrize("size", [40, 64, 96])
def test_clip_features_match_the_jax_extractor(tiny_clip, size):
    module, params, torch_model = tiny_clip
    images = np.random.RandomState(size).randint(0, 256, (5, size, size, 3)).astype(np.uint8)
    want = jfid.CLIPFeatureExtractor(module=module, params={"params": params}, image_size=64,
                                     batch_size=2)(images)
    got = tfid.CLIPFeatureExtractor(module=torch_model, image_size=64, batch_size=2,
                                    device="cpu")(images)
    assert got.shape == (5, 16) and got.dtype == np.float32
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-6)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_evaluate_clip_fid_from_a_local_directory(tmp_path, capsys):
    """``python -m dmtpu_torch.scripts.evaluate --clip_pretrained DIR``: a
    local torch CLIP directory (one layer a tower, 224² images in 32² patches)
    gives the CLIP-FID of the extractor on the same images."""
    from PIL import Image
    from transformers import CLIPConfig, CLIPModel, CLIPTextConfig, CLIPVisionConfig

    from dmtpu_torch.scripts import evaluate

    text = CLIPTextConfig(vocab_size=64, hidden_size=32, intermediate_size=64,
                          num_hidden_layers=1, num_attention_heads=4, projection_dim=16)
    vision = CLIPVisionConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=1,
                              num_attention_heads=4, image_size=224, patch_size=32,
                              projection_dim=16)
    torch.manual_seed(0)
    CLIPModel(CLIPConfig(text_config=text.to_dict(), vision_config=vision.to_dict(),
                         projection_dim=16)).save_pretrained(str(tmp_path / "clip"))
    rs = np.random.RandomState(8)
    for side, shift in (("real", 0), ("fake", 60)):
        os.makedirs(tmp_path / side)
        for i in range(24):
            img = np.clip(rs.randint(0, 196, (48, 48, 3)) + shift, 0, 255).astype(np.uint8)
            Image.fromarray(img).save(tmp_path / side / f"{i}.png")
    real, fake = str(tmp_path / "real"), str(tmp_path / "fake")
    results = evaluate.main(["--real_dir", real, "--fake_dir", fake, "--device", "cpu",
                             "--clip_pretrained", str(tmp_path / "clip"), "--n_max", "20"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    ext = tfid.CLIPFeatureExtractor(str(tmp_path / "clip"), device="cpu")
    want = tfid.compute_fid(evaluate.load_images_u8(real, limit=20),
                            evaluate.load_images_u8(fake, limit=20), ext)
    assert list(line) == ["clip_fid"] and np.isfinite(line["clip_fid"]) and want > 0
    assert results["clip_fid"] == pytest.approx(want, rel=1e-9)
    assert line["clip_fid"] == round(want, 4)


def test_clip_extractor_needs_a_card_unless_asked_for_the_cpu(tiny_clip, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfid.CLIPFeatureExtractor(module=tiny_clip[2])
