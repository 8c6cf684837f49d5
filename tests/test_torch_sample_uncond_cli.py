"""``python -m dmtpu_torch.scripts.sample_uncond`` on the CPU.

The whole sampler x mode matrix of the JAX CLI on a tiny UNet (8x8 images,
the JAX package's ``.npz`` export of seeded random params): every pair the
JAX CLI takes writes its PNGs, every other pair is refused with the JAX
CLI's message, and the matrix itself is read from the JAX script's source.
Reconstruction reads a temporary ``ImageDir``.  The modes' work is held
against the JAX package on the same arrays: a fold's samples (DDIM, Heun,
flow), a denoise trajectory, an interpolation row and a reconstruction
(DDIM and flow inversion), each through the JAX UNet with the same params,
to a relative L2 of 1e-4.
"""
import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmtpu.diffusions import DDIM as JaxDDIM
from dmtpu.diffusions import FlowMatching as JaxFlow
from dmtpu.diffusions import HeunSampler as JaxHeun
from dmtpu.models.unet import UNet as JaxUNet
from dmtpu_torch.convert import load_flax_params
from dmtpu_torch.models.unet import UNet
from dmtpu_torch.scripts import sample_uncond
from dmtpu_torch.utils.config import Config
from tests._tiny_fixtures import write_yaml
from tests._torch_helpers import jax_random_params, nhwc, t

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOOP = 1e-4
MODEL = dict(in_channels=3, out_channels=3, dim=32, dim_mults=[1, 2], use_attn=[False, True],
             num_res_blocks=1, dropout=0.0)
DIFFUSION = {"target": "diffusions.ddpm.DDPM",
             "params": {"total_steps": 100, "beta_schedule": "linear", "objective": "pred_eps",
                        "var_type": "fixed_small", "respace_type": "uniform",
                        "respace_steps": 4}}
CONF = Config({"data": {"params": {"img_size": 8}, "img_channels": 3},
               "model": {"target": "models.unet.UNet", "params": MODEL},
               "diffusion": DIFFUSION})


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.fixture(scope="module")
def params():
    return jax_random_params(JaxUNet(**MODEL), jnp.zeros((1, 8, 8, 3)),
                             jnp.zeros((1,), jnp.int32), seed=3)


@pytest.fixture(scope="module")
def files(tmp_path_factory, params):
    """(config path, .npz weights, an ImageDir of three 8x8 images)."""
    root = tmp_path_factory.mktemp("uncond")
    np.savez(root / "unet.npz", params=np.asarray(params, dtype=object))
    images = root / "images"
    images.mkdir()
    from PIL import Image

    rs = np.random.RandomState(0)
    for i in range(3):
        Image.fromarray(rs.randint(0, 256, (8, 8, 3), dtype=np.uint8)).save(images / f"{i}.png")
    return (str(write_yaml(root / "tiny.yaml", CONF.to_dict())), str(root / "unet.npz"),
            str(images))


def _jax_matrix():
    """``COMPATIBLE_SAMPLER_MODE`` as the JAX script's source has it."""
    tree = ast.parse(open(os.path.join(REPO, "scripts", "sample_uncond.py")).read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and node.targets[0].id == "COMPATIBLE_SAMPLER_MODE":
            return {kw.arg: ast.literal_eval(kw.value) for kw in node.value.keywords}
    raise AssertionError("no COMPATIBLE_SAMPLER_MODE in scripts/sample_uncond.py")


def test_the_matrix_is_the_jax_cli_s():
    assert sample_uncond.COMPATIBLE_SAMPLER_MODE == _jax_matrix()


PAIRS = [(s, m) for s in sorted(_jax_matrix()) for m in sample_uncond.MODES]


@pytest.mark.parametrize("sampler,mode", PAIRS)
def test_every_sampler_and_mode(tmp_path, files, sampler, mode):
    conf, weights, images = files
    argv = ["-c", conf, "--weights", weights, "--save_dir", str(tmp_path / "out"),
            "--n_samples", "2", "--batch_size", "2", "--sampler", sampler, "--mode", mode,
            "--device", "cpu", "--n_denoise", "2", "--n_progressive", "2",
            "--n_interpolate", "3", "--input_dir", images]
    if mode not in _jax_matrix()[sampler]:
        with pytest.raises(ValueError, match=f"^mode {mode} is incompatible with sampler "
                                             f"{sampler}$"):
            sample_uncond.main(argv)
        return
    sample_uncond.main(argv)
    from PIL import Image

    out = sorted(os.listdir(tmp_path / "out"))
    assert out == ["0.png", "1.png"]
    size = np.asarray(Image.open(tmp_path / "out" / "0.png")).shape
    # grids of 8-pixel images with 2-pixel padding; denoise / progressive keep
    # every (4 // 2)-th of the 4 steps, ending at the last: 2 columns
    cols = {"denoise": 2, "progressive": 2, "interpolate": 3, "reconstruction": 2}.get(mode)
    assert size[:2] == ((8, 8) if cols is None else (12, 2 + 10 * cols))


def test_refusals_and_flags(files, tmp_path):
    conf, weights, _ = files
    base = ["-c", conf, "--weights", weights, "--save_dir", str(tmp_path), "--n_samples", "1",
            "--device", "cpu"]
    with pytest.raises(SystemExit, match="flowdpm IS the solver"):
        sample_uncond.main(base + ["--sampler", "flowdpm", "--flow_solver", "heun"])
    with pytest.raises(SystemExit, match="--input_dir required"):
        sample_uncond.main(base + ["--sampler", "ddim", "--mode", "reconstruction",
                                   "--input_dir", ""])
    args, _ = sample_uncond.parse_args(base)
    assert args.batch_size == 500 and args.sampler == "ddpm" and args.mode == "sample"
    flow = sample_uncond.build_diffuser(sample_uncond.parse_args(
        base + ["--sampler", "flow", "--flow_solver", "heun", "--time_shift", "3"])[0], CONF)
    assert flow.solver == "heun" and flow.time_shift == 3.0
    dpm = sample_uncond.build_diffuser(sample_uncond.parse_args(
        base + ["--sampler", "flowdpm"])[0], CONF)
    assert type(dpm).__name__ == "FlowDPMSolver"


def test_device_cuda_without_a_card_raises(files, tmp_path, monkeypatch):
    conf, weights, _ = files
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        sample_uncond.main(["-c", conf, "--weights", weights, "--save_dir", str(tmp_path),
                            "--n_samples", "1"])


def _port(params):
    model = load_flax_params(UNet(**MODEL), params).eval()
    return sample_uncond.model_function(model)


def _jax_fn(params):
    jmod = JaxUNet(**MODEL)
    return lambda x, tt, **kw: jmod.apply(params, x, tt)


SAMPLERS = {"ddim": (JaxDDIM, sample_uncond.DDIM), "heun": (JaxHeun, sample_uncond.HeunSampler),
            "flow": (JaxFlow, sample_uncond.FlowMatching)}


@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_a_fold_matches_jax_on_the_same_noise(params, name):
    jcls, tcls = SAMPLERS[name]
    kw = dict(DIFFUSION["params"])
    got, ys = sample_uncond.sample_fold(_port(params), tcls(**kw), 1, 2, (3, 8, 8), seed=5,
                                        device="cpu", collect=("sample",))
    noise = torch.randn(2, 3, 8, 8, generator=sample_uncond.fold_generator(5, 1, "cpu"))
    want, wys = jcls(**kw).sample_loop(_jax_fn(params), jnp.asarray(nhwc(noise.numpy())),
                                       jax.random.PRNGKey(0), collect=("sample",))
    assert _rel_l2(nhwc(got.numpy()), want) <= LOOP
    assert _rel_l2(np.transpose(ys["sample"].numpy(), (0, 1, 3, 4, 2)), wys["sample"]) <= LOOP


def test_an_interpolation_row_matches_jax(params):
    kw = dict(DIFFUSION["params"])
    got = sample_uncond.interpolate_row(_port(params), sample_uncond.DDIM(**kw), 2, 4, (3, 8, 8),
                                        seed=5, device="cpu")
    g = sample_uncond.fold_generator(5, 2, "cpu")
    z1, z2 = (torch.randn(3, 8, 8, generator=g).numpy() for _ in range(2))
    a, b = jnp.asarray(nhwc(z1[None]))[0], jnp.asarray(nhwc(z2[None]))[0]
    theta = jnp.arccos(jnp.sum(a * b) / (jnp.linalg.norm(a) * jnp.linalg.norm(b)))
    # the JAX CLI's slerp (scripts/sample_uncond.py), on the port's two noises
    noise = jnp.stack([jnp.sin((1 - tt) * theta) / jnp.sin(theta) * a
                       + jnp.sin(tt * theta) / jnp.sin(theta) * b
                       for tt in jnp.linspace(0, 1, 4)])
    want = JaxDDIM(**kw).sample(_jax_fn(params), noise, jax.random.PRNGKey(0))
    assert _rel_l2(nhwc(got.numpy()), want) <= LOOP


@pytest.mark.parametrize("name", ["ddim", "flow"])
def test_reconstruction_matches_jax(params, name):
    jcls, tcls = SAMPLERS[name]
    kw = dict(DIFFUSION["params"])
    img = np.clip(np.random.RandomState(7).randn(2, 3, 8, 8).astype(np.float32), -1, 1)
    got = sample_uncond.reconstruct(_port(params), tcls(**kw), t(img))
    jd, fn = jcls(**kw), _jax_fn(params)
    want = jd.sample(fn, jd.sample_inversion(fn, jnp.asarray(nhwc(img))), jax.random.PRNGKey(0))
    assert _rel_l2(nhwc(got.numpy()), want) <= LOOP
