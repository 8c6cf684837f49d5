"""The guidance and editing CLIs of dmtpu_torch.scripts on the CPU.

``sample_sdedit``, ``sample_ilvr``, ``sample_mask_guidance``, ``sample_ddib``
and ``sample_clip_guidance``: each answers ``--help``, and each runs end to
end through ``main(argv)`` with ``--device cpu`` on a tiny model (the repo's
UNet, or the AdaGN UNet for DDIB's labels, 8x8 images, the JAX package's
``.npz`` export of seeded random params) over a temporary ``ImageDir``,
writing its grids (2-pixel padding: a pair is 12 x 22 pixels, a triptych
12 x 32).  SDEdit's request (``edit_batch``) and DDIB's (``translate_batch``)
are held against the JAX package's primitives through the JAX UNets on the
same params (the bridge carries them over), SDEdit on the noise arrays JAX
drew (``torch.randn`` patched to hand them out): relative L2 1e-4, f32
rounding order through a UNet over a few steps.
"""
import argparse
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmtpu.diffusions import DDIM as JaxDDIM
from dmtpu.diffusions import DDPM as JaxDDPM
from dmtpu.models.unet import UNet as JaxUNet
from dmtpu.models.unet_categorial_adagn import UNetCategorialAdaGN as JaxAdaGN
from dmtpu_torch.convert import load_flax_params
from dmtpu_torch.diffusions import DDIM, DDPM
from dmtpu_torch.models.unet import UNet
from dmtpu_torch.models.unet_categorial_adagn import UNetCategorialAdaGN
from dmtpu_torch.scripts import (
    sample_clip_guidance,
    sample_ddib,
    sample_ilvr,
    sample_mask_guidance,
    sample_sdedit,
)
from tests._tiny_fixtures import write_yaml
from tests._torch_helpers import char_tokenizer_dir, jax_random_params, nhwc, t

LOOP = 1e-4
UNET = dict(in_channels=3, out_channels=3, dim=32, dim_mults=[1, 2], use_attn=[False, True],
            num_res_blocks=1, dropout=0.0)
ADAGN = dict(UNET, num_classes=5, attn_head_dims=32)
DIFFUSION = {"target": "diffusions.ddpm.DDPM",
             "params": {"total_steps": 100, "beta_schedule": "linear", "objective": "pred_eps",
                        "var_type": "fixed_small"}}
CLIS = [sample_sdedit, sample_ilvr, sample_mask_guidance, sample_ddib, sample_clip_guidance]


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _conf(target, params):
    return {"data": {"params": {"img_size": 8}, "img_channels": 3},
            "model": {"target": target, "params": params}, "diffusion": DIFFUSION}


@pytest.fixture(scope="module")
def params():
    x, tt = jnp.zeros((1, 8, 8, 3)), jnp.zeros((1,), jnp.int32)
    return {"unet": jax_random_params(JaxUNet(**UNET), x, tt, seed=3),
            "adagn": jax_random_params(JaxAdaGN(**ADAGN), x, tt, tt, seed=4)}


@pytest.fixture(scope="module")
def files(tmp_path_factory, params):
    """Configs, .npz weights and an ImageDir of three seeded 8x8 PNGs."""
    from PIL import Image

    root = tmp_path_factory.mktemp("guidance_cli")
    out = {"images": str(root / "images")}
    os.makedirs(out["images"])
    rs = np.random.RandomState(0)
    for i in range(3):
        Image.fromarray(rs.randint(0, 256, (8, 8, 3), dtype=np.uint8)).save(
            os.path.join(out["images"], f"{i}.png"))
    for name, target, model in (("unet", "models.unet.UNet", UNET),
                                ("adagn", "models.unet_categorial_adagn.UNetCategorialAdaGN",
                                 ADAGN)):
        np.savez(root / f"{name}.npz", params=np.asarray(params[name], dtype=object))
        out[name] = (write_yaml(root / f"{name}.yaml", _conf(target, model)),
                     str(root / f"{name}.npz"))
    return out


@pytest.fixture(scope="module")
def clip_dir(tmp_path_factory):
    """A local torch CLIP directory: a tiny ViT at CLIP's 224 pixels and a
    character-level tokenizer (no Flax model)."""
    from transformers import CLIPConfig, CLIPModel

    path = str(tmp_path_factory.mktemp("clip"))
    text = dict(vocab_size=256, hidden_size=32, intermediate_size=64, num_hidden_layers=1,
                num_attention_heads=4, max_position_embeddings=77, projection_dim=16)
    vision = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=1,
                  num_attention_heads=4, image_size=224, patch_size=32, projection_dim=16)
    torch.manual_seed(0)
    CLIPModel(CLIPConfig(text_config=text, vision_config=vision, projection_dim=16)
              ).save_pretrained(path)
    return char_tokenizer_dir(path)


def _pngs(path):
    from PIL import Image

    names = sorted(os.listdir(path))
    return names, {np.asarray(Image.open(os.path.join(path, n))).shape for n in names}


@pytest.mark.parametrize("cli", CLIS, ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_help(cli, capsys):
    assert isinstance(cli.build_parser(), argparse.ArgumentParser)
    with pytest.raises(SystemExit) as e:
        cli.main(["--help"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert "--weights" in out and "--device" in out and "--save_dir" in out


@pytest.mark.parametrize("cli,model,flags,grid", [
    (sample_sdedit, "unet", ["--edit_steps", "2"], (12, 22, 3)),
    (sample_ilvr, "unet", ["--downsample_factor", "2", "--interp_method", "lanczos2"],
     (12, 22, 3)),
    (sample_mask_guidance, "unet", ["--mask_type", "center"], (12, 32, 3)),
    (sample_mask_guidance, "unet", ["--mask_type", "half", "--resample", "--resample_r", "2",
                                    "--resample_j", "2"], (12, 32, 3)),
    (sample_ddib, "adagn", ["--class_A", "1", "--class_B", "3"], (12, 22, 3)),
], ids=["sdedit", "ilvr", "mask", "repaint", "ddib"])
def test_main_writes_its_grids(tmp_path, files, cli, model, flags, grid):
    conf, weights = files[model]
    save = tmp_path / "out"
    cli.main(["-c", conf, "--weights", weights, "--save_dir", str(save), "--device", "cpu",
              "--input_dir", files["images"], "--batch_size", "2", "--respace_steps", "4",
              *flags])
    names, shapes = _pngs(save)
    assert names == ["0.png", "1.png", "2.png"] and shapes == {grid}


def test_clip_guidance_main_writes_its_samples(tmp_path, files, clip_dir):
    conf, weights = files["unet"]
    save = tmp_path / "out"
    sample_clip_guidance.main(["-c", conf, "--weights", weights, "--save_dir", str(save),
                               "--device", "cpu", "--text", "a cat", "--n_samples", "3",
                               "--batch_size", "2", "--respace_steps", "3",
                               "--clip_pretrained", clip_dir, "--guidance_weight", "100"])
    names, shapes = _pngs(save)
    assert names == ["0.png", "1.png", "2.png"] and shapes == {(8, 8, 3)}


def test_the_cuda_default_needs_a_card(tmp_path, files, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    conf, weights = files["unet"]
    with pytest.raises(SystemExit, match="no CUDA device; pass --device cpu"):
        sample_sdedit.main(["-c", conf, "--weights", weights, "--save_dir", str(tmp_path),
                            "--input_dir", files["images"], "--edit_steps", "1"])


def _images(seed):
    return np.random.RandomState(seed).uniform(-1, 1, (2, 3, 8, 8)).astype(np.float32)


@pytest.mark.parametrize("edit_steps", [1, 3, 6])
def test_sdedit_matches_the_jax_primitives(params, monkeypatch, edit_steps):
    """t_edit, the start row, the diffusion and the partial DDPM loop, through
    the same UNet weights and on the same noise."""
    kw = dict(DIFFUSION["params"], respace_type="uniform", respace_steps=6)
    jd, td = JaxDDPM(**kw), DDPM(**kw)
    S = len(jd.respaced_seq)
    t_edit, start_row = sample_sdedit.edit_rows(td, edit_steps)
    assert (t_edit, start_row) == (int(jd.respaced_seq[edit_steps - 1]), S - edit_steps)
    img = _images(edit_steps)
    jmod = JaxUNet(**UNET)
    key = jax.random.PRNGKey(edit_steps)
    k1, k2 = jax.random.split(key)
    eps = jax.random.normal(k1, nhwc(img).shape)
    xt = jd.diffuse(jnp.asarray(nhwc(img)), jnp.full((2,), t_edit), eps)
    want = jd.sample(lambda x, tt, **_: jmod.apply(params["unet"], x, tt), xt, k2,
                     start_step=start_row)
    # the JAX loop's draws: keys (edit_steps, 2), each step's noise from key[i, 0]
    keys = jax.random.split(k2, (edit_steps, 2))
    queue = [t(np.transpose(np.asarray(a), (0, 3, 1, 2))) for a in
             [eps] + [jax.random.normal(keys[i, 0], nhwc(img).shape) for i in range(edit_steps)]]

    def fake_randn(*shape, **_):
        out = queue.pop(0)
        assert tuple(out.shape) == tuple(shape[0] if len(shape) == 1 else shape)
        return out

    model = load_flax_params(UNet(**UNET), params["unet"]).eval()
    monkeypatch.setattr(torch, "randn", fake_randn)
    got = sample_sdedit.edit_batch(lambda x, tt, **_: model(x, tt), td, t(img), edit_steps)
    monkeypatch.undo()
    assert not queue
    assert _rel_l2(nhwc(got.numpy()), want) <= LOOP
    with pytest.raises(ValueError, match=r"edit_steps must be in \(0, 7\]"):
        sample_sdedit.edit_rows(td, 8)


def test_ddib_matches_the_jax_primitives(params):
    """DDIM inversion under class A, then DDIM sampling under class B, with
    the labels as the model's third argument."""
    kw = dict(DIFFUSION["params"], respace_type="uniform", respace_steps=5)
    img = _images(7)
    jmod = JaxAdaGN(**ADAGN)

    def jfn(label):
        return lambda x, tt, **_: jmod.apply(params["adagn"], x, tt,
                                             jnp.full((x.shape[0],), label, jnp.int32))

    jd = JaxDDIM(**kw)
    noise = jd.sample_inversion(jfn(1), jnp.asarray(nhwc(img)))
    want = jd.sample(jfn(3), noise, jax.random.PRNGKey(0))
    model = load_flax_params(UNetCategorialAdaGN(**ADAGN), params["adagn"]).eval()
    got = sample_ddib.translate_batch(model, DDIM(**kw), t(img), 1, 3)
    assert _rel_l2(nhwc(got.numpy()), want) <= LOOP
    # the labels matter: another target class gives another image
    other = sample_ddib.translate_batch(model, DDIM(**kw), t(img), 1, 4)
    assert _rel_l2(other.numpy(), got.numpy()) > 1e-3
