"""dmtpu_torch's SDXL page logic (``dmtpu_torch/ui/sdxl.py``) against the
Generate button of ``streamlit/pages/4_Stable_Diffusion_XL.py`` run as the
same calls in dmtpu, on ``tests/_tiny_fixtures.py::tiny_sdxl_config`` in
f32 on the CPU, with the noise handed to both; and ``load_weights``' input
layouts (item I) for the SD and SDXL wrappers.

Tolerance: the decoded images within 1e-3 relative L2 after 5 DDIMCFG steps
(f32 sums in another order through the towers, 5 UNet calls and the
decode); weights loaded from a file equal the source bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmtpu.diffusions import DDIMCFG as JaxDDIMCFG
from dmtpu.utils.config import instantiate_from_config as jax_instantiate
from dmtpu_torch.convert import load_flax_params, sdxl_state_dict_from_flax
from dmtpu_torch.models.stablediffusion import StableDiffusion
from dmtpu_torch.ui import sdxl as ui
from dmtpu_torch.utils.config import instantiate_from_config, load_config
from tests._tiny_fixtures import _tiny_sd_model, tiny_sdxl_config
from tests._torch_helpers import jax_random_params, nhwc
from tests.test_torch_sdxl import jax_sdxl_params

SIZE, STEPS, SCALE = 64, 5, 5.0


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(yaml path, config, JAX wrapper, its params)."""
    path = tiny_sdxl_config(tmp_path_factory.mktemp("sdxl") / "sdxl.yaml")
    conf = load_config(path)
    jw = jax_instantiate(conf.model)
    return path, conf, jw, jax_sdxl_params(jw, SIZE)


def _npz(tmp_path, params, name="w.npz"):
    path = str(tmp_path / name)
    np.savez(path, params=params)  # as the JAX merge_lora writes it
    return path


def _jax_generate(conf, jw, params, ids, noise, b):
    """The page's Generate body (:69-117) in dmtpu, DDIM, the noise given."""
    dp = dict(conf.diffusion.get("params", {}))
    dp.update(respace_type="uniform-linspace", respace_steps=STEPS, guidance_scale=SCALE,
              cond_kwarg="cond")
    diffuser = JaxDDIMCFG(**dp)
    size = jnp.tile(jnp.array([[SIZE, SIZE]], jnp.float32), (b, 1))
    sizes = dict(original_size=size, crop_coords=jnp.zeros((b, 2), jnp.float32),
                 target_size=size)
    ids_l, ids_g = (jnp.asarray(np.repeat(x, b, 0)) for x in ids)
    cond = jw.conditioner(params["conditioner"], ids_l, ids_g, **sizes)
    uncond = jw.conditioner(params["conditioner"], ids_l, ids_g, force_zero_text=True, **sizes)
    z = diffuser.sample(jw.make_model_fn(params), jnp.asarray(nhwc(noise)),
                        jax.random.PRNGKey(0), uncond_conditioning=uncond,
                        model_kwargs=dict(cond=cond))
    return np.clip(np.asarray(jw.decode_latent(params, z)), -1, 1)


def test_generate_matches_the_page_s_calls_in_jax(setup, tmp_path, monkeypatch):
    """A 5-step DDIMCFG request, s = 5, empty negative, b2: the images of
    ``generate_sdxl`` (weights from the JAX package's ``.npz`` through
    ``load_sdxl``) against the same calls in dmtpu, within 1e-3."""
    path, conf, jw, params = setup
    rs = np.random.RandomState(11)
    ids = (rs.randint(0, 256, (1, 77)), rs.randint(0, 256, (1, 77)))
    noise = rs.randn(2, 4, SIZE // 8, SIZE // 8).astype(np.float32)
    want = _jax_generate(conf, jw, params, ids, noise, 2)
    _, model = ui.load_sdxl(path, weights=_npz(tmp_path, params), device="cpu")
    drawn = []

    def fixed_noise(batch, shape, generator, device):
        drawn.append((batch, tuple(shape)))
        return torch.from_numpy(noise).to(device)

    monkeypatch.setattr(ui, "_noise", fixed_noise)
    got, stage_ms = ui.generate_sdxl(conf, model, ids, "", steps=STEPS, scale=SCALE,
                                     height=SIZE, width=SIZE, batch_size=2, device="cpu")
    assert drawn == [(2, (4, 8, 8))] and stage_ms == {}
    assert got.shape == (2, 3, SIZE, SIZE) and np.abs(want).max() > 0.1
    err = np.linalg.norm(nhwc(got.numpy()) - want) / np.linalg.norm(want)
    assert err <= 1e-3, err


def test_generate_options(setup):
    """Each sampler of the page, batch count, offset noise and a token-id
    negative run; the request is a function of its seed; a text prompt needs
    tokenizers; the default device is the card."""
    path, conf, _, _ = setup
    _, model = ui.load_sdxl(path, device="cpu", generator=torch.Generator().manual_seed(1))
    for p in model.unet.parameters():  # the zero-initialised output conv would hide the prompt
        if not p.any():
            torch.nn.init.normal_(p, std=0.05)
    rs = np.random.RandomState(12)
    ids = (rs.randint(0, 256, (77,)), rs.randint(0, 256, (77,)))
    neg = (rs.randint(0, 256, (77,)), rs.randint(0, 256, (77,)))
    kw = dict(steps=3, height=32, width=48, device="cpu")
    outs = {}
    for sampler in ui.SAMPLERS:
        outs[sampler], _ = ui.generate_sdxl(conf, model, ids, neg, sampler=sampler, seed=5,
                                            batch_count=2, offset_noise=0.1, **kw)
        assert outs[sampler].shape == (2, 3, 32, 48)
        assert torch.isfinite(outs[sampler]).all() and outs[sampler].abs().max() <= 1
        assert not torch.equal(outs[sampler][0], outs[sampler][1])  # batch 1's own noise
    again, _ = ui.generate_sdxl(conf, model, ids, neg, sampler="DDPM", seed=5, batch_count=2,
                                offset_noise=0.1, **kw)
    assert torch.equal(again, outs["DDPM"])
    other, _ = ui.generate_sdxl(conf, model, ids, neg, sampler="DDPM", seed=6, batch_count=2,
                                offset_noise=0.1, **kw)
    assert not torch.equal(other, outs["DDPM"])
    empty, _ = ui.generate_sdxl(conf, model, ids, None, seed=5, batch_count=2,
                                offset_noise=0.1, **kw)
    assert not torch.equal(empty, outs["DDIM"])  # the zeroed text is another negative
    with pytest.raises(ValueError, match="tokenizers"):
        ui.generate_sdxl(conf, model, "a cat", **kw)
    with pytest.raises(ValueError, match="sampler"):
        ui.generate_sdxl(conf, model, ids, sampler="Euler", **kw)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ui.load_sdxl(path)


def test_load_sdxl_is_seeded_and_reads_checkpoints(setup, tmp_path):
    """Random weights are a function of the generator; an sgm ``.ckpt`` under
    ``state_dict``, ``ema.shadow`` or ``model`` and a torch file in the
    port's layout load the same weights."""
    path, conf, _, params = setup
    _, a = ui.load_sdxl(path, device="cpu", generator=torch.Generator().manual_seed(2))
    _, b = ui.load_sdxl(path, device="cpu", generator=torch.Generator().manual_seed(2))
    for (name, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(p, q), name
    _, src = ui.load_sdxl(conf, weights=_npz(tmp_path, params), device="cpu")
    want = sdxl_state_dict_from_flax(params)
    for name, value in src.state_dict().items():
        assert torch.equal(value, want[name]), name
    sgm = {f"model.diffusion_model.{k}": v for k, v in src.unet.state_dict().items()}
    sgm.update({f"first_stage_model.{k}": v for k, v in src.vae.state_dict().items()})
    sgm.update({f"conditioner.embedders.0.transformer.text_model.{k}": v
                for k, v in src.conditioner.clip_l.state_dict().items()})
    sgm.update({f"conditioner.embedders.1.model.{k}": v
                for k, v in _hf_g(src.conditioner.clip_g.state_dict()).items()})
    for layout, blob in (("state_dict", {"state_dict": sgm, "global_step": 3}),
                         ("ema", {"ema": {"shadow": sgm}}), ("model", {"model": sgm}),
                         ("own", src.state_dict())):
        torch.save(blob, tmp_path / f"{layout}.ckpt")
        _, got = ui.load_sdxl(path, weights=str(tmp_path / f"{layout}.ckpt"), device="cpu")
        for name, value in src.state_dict().items():
            assert torch.equal(got.state_dict()[name], value), (layout, name)


def _hf_g(tower_sd):
    """bigG in the HF layout, as ``hf_clip_text_strip`` reads it."""
    return {f"text_model.{k}" if k != "text_projection" else k: v for k, v in tower_sd.items()}


@pytest.mark.parametrize("layout", ["ema_shadow", "model", "npz"])
def test_sd_load_weights_reads_every_layout(tmp_path, layout):
    """Item I: ``StableDiffusion.load_weights`` takes a CompVis ``.ckpt`` with
    ``ema.shadow`` or ``model`` at the top, and the ``.npz`` that the JAX
    ``merge_lora`` writes (``params``: ``{"unet", "vae", "text_encoder"}``),
    as ``dmtpu/models/stablediffusion/__init__.py:86-96`` does."""
    conf = _tiny_sd_model()
    src = instantiate_from_config(conf).init_params(torch.Generator().manual_seed(4))
    if layout == "npz":
        jsd = jax_instantiate(conf)
        n = jsd.text_encoder.max_length
        params = {
            "unet": jax_random_params(jsd.unet, jnp.zeros((1, 8, 8, 4)),
                                      jnp.zeros((1,), jnp.int32),
                                      jnp.zeros((1, n, jsd.unet.context_dim)), seed=1),
            "vae": jax_random_params(jsd.vae, jnp.zeros((1, 64, 64, 3)), jax.random.PRNGKey(0),
                                     seed=2),
            "text_encoder": jax_random_params(jsd.text_encoder.model,
                                              jnp.ones((1, n), jnp.int32), seed=3)}
        load_flax_params(src.unet, params["unet"])
        load_flax_params(src.vae, params["vae"])
        load_flax_params(src.text_encoder.model, params["text_encoder"])
        path = _npz(tmp_path, params)
    else:
        compvis = {f"model.diffusion_model.{k}": v for k, v in src.unet.state_dict().items()}
        compvis.update({f"first_stage_model.{k}": v for k, v in src.vae.state_dict().items()})
        compvis.update({f"cond_stage_model.transformer.text_model.{k}": v
                        for k, v in src.text_encoder.model.state_dict().items()})
        blob = {"ema": {"shadow": compvis}} if layout == "ema_shadow" else {"model": compvis}
        path = str(tmp_path / "w.ckpt")
        torch.save(blob, path)
    got = instantiate_from_config(conf).load_weights(path)
    assert isinstance(got, StableDiffusion)
    for name, value in src.state_dict().items():
        assert torch.equal(got.state_dict()[name], value), name
