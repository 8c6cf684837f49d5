"""The port's CLIs under a ``torchrun``-like launch of 2 gloo ranks on the
CPU (``tests/_torch_dist.py`` sets ``WORLD_SIZE`` / ``RANK`` /
``LOCAL_RANK``): the four train CLIs and the nine sampling CLIs split each
global batch over the ranks and write what their one-rank run writes.

Each CLI runs once in this process (one rank) and once on each of the two
ranks, on tiny configs (the other CLI tests' fixtures) with seeded weights
and no dropout: a rank draws its own dropout masks, and MMDiT's conditioning
dropout draws from the dropout generator, so both are off here
(``cond_dropout_prob=0``).  The sampling batches do not divide evenly (5 or
3 rows over 2 ranks: padded by wrapping, then trimmed).  Compared: every PNG
written (to one uint8 level: the rows of a smaller batch sum in another
order) and each train run's last checkpoint (parameters and EMA to 1e-5,
after two SGD steps), written by rank 0 alone.
"""
import glob
import os

import numpy as np
import pytest
import torch
import yaml

from dmtpu_torch.models.unet import UNet
from dmtpu_torch.models.unet_categorial_adagn import UNetCategorialAdaGN
from dmtpu_torch.utils import checkpoint as ckpt_lib
from tests import _torch_parallel_workers as W
from tests._tiny_fixtures import tiny_sd_config, tiny_sd_train_config, write_yaml
from tests._torch_dist import spawn
from tests._torch_helpers import char_tokenizer_dir

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UNET = dict(in_channels=3, out_channels=3, dim=32, dim_mults=[1, 2], use_attn=[False, True],
            num_res_blocks=1, dropout=0.0)
ADAGN = dict(UNET, num_classes=5, attn_head_dims=32)
DIFFUSION = {"target": "diffusions.ddpm.DDPM",
             "params": {"total_steps": 100, "beta_schedule": "linear", "objective": "pred_eps",
                        "var_type": "fixed_small"}}
# SGD: Adam's first step moves a parameter by about lr whatever its gradient's
# size, so the rounding noise of a gradient that is zero by the model's math
# (a bias ahead of a GroupNorm) would flip signs between summation orders
TRAIN = ["-ni", "--device", "cpu", "train.sample_freq=0", "train.n_steps=2",
         "train.save_freq=2", "train.print_freq=1", "train.optim.target=torch.optim.SGD",
         "train.optim.params.lr=0.01"]


def _pixel_conf(root, name, target, params):
    return write_yaml(root / f"{name}.yaml", {
        "data": {"params": {"img_size": 8}, "img_channels": 3, "num_classes": 5},
        "model": {"target": target, "params": params}, "diffusion": DIFFUSION})


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """(the CLI runs, their root directory)."""
    from PIL import Image
    from tests.test_sample_mmdit_cli import TINY_CONF
    from tests.test_torch_train_ddpm_cfg_cli import DIT, _conf as cfg_conf
    from tests.test_torch_train_mmdit_cli import _conf as mmdit_conf

    root = tmp_path_factory.mktemp("dp_cli")
    images = root / "images"
    images.mkdir()
    rs = np.random.RandomState(0)
    for i in range(3):
        Image.fromarray(rs.randint(0, 256, (8, 8, 3), dtype=np.uint8)).save(images / f"{i}.png")
    torch.manual_seed(0)
    unet, adagn = str(root / "unet.pt"), str(root / "adagn.pt")
    torch.save(UNet(**UNET).state_dict(), unet)
    torch.save(UNetCategorialAdaGN(**ADAGN).state_dict(), adagn)
    unet_conf = _pixel_conf(root, "unet", "models.unet.UNet", UNET)
    adagn_conf = _pixel_conf(root, "adagn", "models.unet_categorial_adagn.UNetCategorialAdaGN",
                             ADAGN)
    tok = char_tokenizer_dir(root / "tokenizer")
    (root / "mmdit.yaml").write_text(TINY_CONF)
    sampling = ["--device", "cpu", "--save_dir", "{out}", "--respace_steps", "3"]
    pixel = lambda conf, w: ["-c", conf, "--weights", w, *sampling]  # noqa: E731
    edit = ["--input_dir", str(images), "--batch_size", "3"]
    return [
        ("train_ddpm", ["-c", os.path.join(REPO, "configs", "ddpm_synthetic.yaml"), "-e", "{out}",
                        *TRAIN, "data.params.img_size=8", "data.params.n=16",
                        "dataloader.num_workers=0", "train.batch_size=4"]),
        ("train_ddpm_cfg", ["-c", write_yaml(root / "dit.yaml", cfg_conf(DIT)), "-e", "{out}",
                            *TRAIN]),
        ("train_mmdit", ["-c", write_yaml(root / "mmdit_train.yaml", mmdit_conf()), "-e", "{out}",
                         *TRAIN, "model.params.cond_dropout_prob=0.0"]),
        ("train_sd", ["-c", tiny_sd_train_config(root / "sd_train.yaml", tok), "-e", "{out}",
                      *TRAIN]),
        ("sample_uncond", [*pixel(unet_conf, unet), "--sampler", "ddpm", "--n_samples", "5",
                           "--batch_size", "5"]),
        ("sample_cfg", [*pixel(adagn_conf, adagn), "--class_ids", "1", "--n_samples_each_class",
                        "3", "--batch_size", "3", "--guidance_scale", "3.0"]),
        ("sample_sd", ["-c", tiny_sd_config(root / "sd.yaml"), "--prompt", "a cat",
                       "--save_dir", "{out}", "--device", "cpu", "--n_samples", "3",
                       "--batch_size", "3", "--height", "32", "--width", "32",
                       "--sampler", "ddpm", "--respace_steps", "2"]),
        ("sample_mmdit", ["-c", str(root / "mmdit.yaml"), "--save_dir", "{out}", "--device",
                          "cpu", "--n_samples", "3", "--batch_size", "3"]),
        ("sample_sdedit", [*pixel(unet_conf, unet), *edit, "--edit_steps", "2"]),
        ("sample_ilvr", [*pixel(unet_conf, unet), *edit, "--downsample_factor", "2"]),
        ("sample_mask_guidance", [*pixel(unet_conf, unet), *edit, "--mask_type", "center"]),
        ("sample_ddib", [*pixel(adagn_conf, adagn), *edit, "--class_A", "1", "--class_B", "3"]),
        ("sample_clip_guidance", [*pixel(unet_conf, unet), "--text", "a cat", "--n_samples", "3",
                                  "--batch_size", "3", "--clip_pretrained",
                                  _clip(root / "clip"), "--guidance_weight", "100"]),
    ], root


def _clip(path):
    from transformers import CLIPConfig, CLIPModel

    text = dict(vocab_size=256, hidden_size=32, intermediate_size=64, num_hidden_layers=1,
                num_attention_heads=4, max_position_embeddings=77, projection_dim=16)
    vision = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=1,
                  num_attention_heads=4, image_size=224, patch_size=32, projection_dim=16)
    torch.manual_seed(0)
    CLIPModel(CLIPConfig(text_config=text, vision_config=vision, projection_dim=16)
              ).save_pretrained(str(path))
    return char_tokenizer_dir(str(path))


def _outputs(d):
    """{relative path: PNG pixels or the last checkpoint's tensors}."""
    from PIL import Image

    out = {}
    for f in sorted(glob.glob(os.path.join(d, "**", "*.png"), recursive=True)):
        if "samples" not in f:
            out[os.path.relpath(f, d)] = np.asarray(Image.open(f)).astype(np.int16)
    ckpts = sorted(glob.glob(os.path.join(d, "ckpt", "step*")))
    if ckpts:
        blob = ckpt_lib.load_checkpoint_host(ckpts[-1])
        out["model"] = {k: v.float().numpy() for k, v in blob["model"].items()}
        out["ema"] = {k: v.float().numpy() for k, v in blob["ema"]["shadow"].items()}
    return out


def test_train_and_sampling_clis_on_two_ranks_are_the_one_rank_runs(jobs):
    runs, root = jobs
    assert W.run_clis(0, 0, runs, str(root)) == list(range(len(runs)))
    ranks = spawn(W.run_clis, 2, root, runs, str(root))
    assert ranks == [list(range(len(runs)))] * 2
    for i, (cli, _) in enumerate(runs):
        want, got = _outputs(root / "0" / str(i)), _outputs(root / "2" / str(i))
        assert want and got.keys() == want.keys(), cli
        for name, w in want.items():
            if isinstance(w, dict):
                for k in w:
                    np.testing.assert_allclose(got[name][k], w[k], rtol=0, atol=1e-5,
                                               err_msg=f"{cli} {name} {k}")
            else:
                assert np.abs(got[name] - w).max() <= 1, f"{cli} {name}"
