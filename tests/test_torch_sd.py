"""dmtpu_torch's StableDiffusion wrapper, and the text-to-image slice as a
whole, against dmtpu's: f32 on the CPU, the tiny stack of
``tests/_tiny_fixtures.py`` built in both packages from the same config.

The JAX params are perturbed with seeded normals and loaded through the param
bridge.  Parts: rtol/atol 3e-4 (f32 sums in another order through ~20
layers).  The whole slice (token ids -> CLIP -> 4-step DDIMCFG over the UNet
-> VAE decode): relative L2 error at most 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmtpu.convert.sd import convert_sd_checkpoint
from dmtpu.diffusions import DDIMCFG as JaxDDIMCFG
from dmtpu.utils.config import instantiate_from_config as jax_instantiate
from dmtpu_torch.convert import load_flax_params
from dmtpu_torch.diffusions import DDIMCFG
from dmtpu_torch.models.stablediffusion import StableDiffusion
from dmtpu_torch.scripts.sample_sd import _demo_token_ids
from dmtpu_torch.utils.config import instantiate_from_config
from tests._tiny_fixtures import _tiny_sd_model
from tests._torch_helpers import nhwc, perturb, t

TOL = dict(rtol=3e-4, atol=3e-4)
IMG = 64  # the tiny VAE halves three times: 8x8 latents


@pytest.fixture(scope="module")
def pair():
    """(JAX wrapper, its perturbed params, the port's wrapper with them)."""
    conf = _tiny_sd_model()
    jsd = jax_instantiate(conf)
    raw = jsd.init_params(jax.random.PRNGKey(0), img_size=IMG)
    params = {name: {"params": perturb(raw[name]["params"], seed)}
              for seed, name in enumerate(("unet", "vae", "text_encoder"))}
    tsd = instantiate_from_config(conf).eval()
    assert isinstance(tsd, StableDiffusion)
    load_flax_params(tsd.unet, params["unet"])
    load_flax_params(tsd.vae, params["vae"])
    load_flax_params(tsd.text_encoder.model, params["text_encoder"])
    return jsd, params, tsd


def _ids(text):
    return _demo_token_ids(text, 16, 256)


def test_text_encode_matches(pair):
    jsd, params, tsd = pair
    ids = np.concatenate([_ids("a tiny cat"), _ids("")])
    want = np.asarray(jsd.text_encoder_encode_tokens(params, jnp.asarray(ids)))
    with torch.no_grad():
        got = tsd.text_encoder_encode_tokens(torch.from_numpy(ids)).numpy()
    assert got.shape == (2, 16, 32)
    np.testing.assert_allclose(got, want, **TOL)


def test_unet_forward_and_model_fn_match(pair):
    jsd, params, tsd = pair
    rs = np.random.RandomState(0)
    x, ctx = rs.randn(2, 4, 8, 8).astype(np.float32), rs.randn(2, 16, 32).astype(np.float32)
    ts = np.array([3, 70])
    want = np.asarray(jsd.unet_forward(params, jnp.asarray(nhwc(x)), jnp.asarray(ts),
                                       jnp.asarray(ctx)))
    with torch.no_grad():
        got = tsd.unet_forward(t(x), torch.from_numpy(ts), t(ctx))
        by_fn = tsd.make_model_fn()(t(x), torch.from_numpy(ts), text_embed=t(ctx), other=1)
        by_call = tsd(t(x), torch.from_numpy(ts), t(ctx))
    np.testing.assert_allclose(nhwc(got.numpy()), want, **TOL)
    assert torch.equal(by_fn, got) and torch.equal(by_call, got)


def test_latent_encode_and_decode_match(pair):
    jsd, params, tsd = pair
    rs = np.random.RandomState(1)
    z, x = rs.randn(2, 4, 8, 8).astype(np.float32), rs.randn(2, 3, IMG, IMG).astype(np.float32)
    want = np.asarray(jsd.decode_latent(params, jnp.asarray(nhwc(z))))
    with torch.no_grad():
        got = tsd.decode_latent(t(z)).numpy()
    assert got.shape == (2, 3, IMG, IMG)
    np.testing.assert_allclose(nhwc(got), want, **TOL)

    # encode: the posterior's moments agree; a sample is scale_factor * (mean + std * noise)
    moments = jsd.vae.apply(params["vae"], jnp.asarray(nhwc(x)), method=jsd.vae.encode_moments)
    mean, logvar = np.split(np.asarray(moments), 2, axis=-1)
    with torch.no_grad():
        a = tsd.encode_latent(t(x), torch.Generator().manual_seed(0))
        b = tsd.encode_latent(t(x), torch.Generator().manual_seed(0))
        c = tsd.encode_latent(t(x), torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a, c)
    noise = torch.randn(a.shape, generator=torch.Generator().manual_seed(0)).numpy()
    want = 0.18215 * (mean + np.exp(0.5 * np.clip(logvar, -30, 20)) * nhwc(noise))
    np.testing.assert_allclose(nhwc(a.numpy()), want, **TOL)


def _text_to_image_jax(jsd, params, ids, uids, noise, steps=4, scale=3.0):
    ce = jsd.text_encoder_encode_tokens(params, jnp.asarray(ids))
    ue = jsd.text_encoder_encode_tokens(params, jnp.asarray(uids))
    sampler = JaxDDIMCFG(scale, "text_embed", total_steps=100, respace_type="uniform",
                         respace_steps=steps)
    z = sampler.sample(jsd.make_model_fn(params), jnp.asarray(nhwc(noise)), jax.random.PRNGKey(0),
                       uncond_conditioning=ue, model_kwargs=dict(text_embed=ce))
    return np.asarray(jsd.decode_latent(params, z))


def _text_to_image_torch(tsd, ids, uids, noise, steps=4, scale=3.0):
    with torch.no_grad():
        ce = tsd.text_encoder_encode_tokens(torch.from_numpy(ids))
        ue = tsd.text_encoder_encode_tokens(torch.from_numpy(uids))
        sampler = DDIMCFG(scale, "text_embed", total_steps=100, respace_type="uniform",
                          respace_steps=steps)
        z = sampler.sample(tsd.make_model_fn(), t(noise), uncond_conditioning=ue,
                           model_kwargs=dict(text_embed=ce))
        return nhwc(tsd.decode_latent(z).numpy())


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_the_slice_as_a_whole_matches(pair):
    """Token ids -> CLIP -> 4-step DDIMCFG (eta 0, the same starting noise)
    -> VAE decode, within 1e-4 relative L2 of the JAX package."""
    jsd, params, tsd = pair
    ids = np.repeat(_ids("a tiny cat"), 2, axis=0)
    uids = np.repeat(_ids(""), 2, axis=0)
    noise = np.random.RandomState(2).randn(2, 4, 8, 8).astype(np.float32)
    want = _text_to_image_jax(jsd, params, ids, uids, noise)
    got = _text_to_image_torch(tsd, ids, uids, noise)
    assert got.shape == (2, IMG, IMG, 3) and np.isfinite(got).all()
    assert _rel_l2(got, want) <= 1e-4
    # the prompt matters: another prompt's image is far outside the tolerance
    other = _text_to_image_torch(tsd, np.repeat(_ids("a dog"), 2, axis=0), uids, noise)
    assert _rel_l2(other, want) > 1e-2


def _compvis_checkpoint(tsd):
    """The port's weights as a CompVis-format checkpoint of numpy arrays,
    with the buffers such a file carries beside the parameters."""
    ckpt = {}
    for prefix, module in (("model.diffusion_model.", tsd.unet), ("first_stage_model.", tsd.vae),
                           ("cond_stage_model.transformer.text_model.", tsd.text_encoder.model)):
        ckpt.update({prefix + k: v.numpy().copy() for k, v in module.state_dict().items()})
    ckpt["cond_stage_model.transformer.text_model.embeddings.position_ids"] = np.arange(16)[None]
    return ckpt


def test_compvis_checkpoint_loads_natively_and_agrees_with_the_jax_converter(pair):
    jsd, _, tsd = pair
    ckpt = _compvis_checkpoint(tsd)
    fresh = instantiate_from_config(_tiny_sd_model()).eval()
    assert fresh.load_state_dict({k: t(v) for k, v in ckpt.items()}) is fresh
    for k, v in tsd.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    # the same file through the JAX package's structural converter, then both
    # stacks run: the native load means what the converter means
    jparams = convert_sd_checkpoint(jsd, ckpt)
    ids, uids = _ids("a tiny cat"), _ids("")
    noise = np.random.RandomState(3).randn(1, 4, 8, 8).astype(np.float32)
    want = _text_to_image_jax(jsd, jparams, ids, uids, noise, steps=2)
    got = _text_to_image_torch(fresh, ids, uids, noise, steps=2)
    assert _rel_l2(got, want) <= 1e-4
    # a module-layout dict still loads as with any nn.Module
    again = instantiate_from_config(_tiny_sd_model())
    again.load_state_dict(tsd.state_dict())
    assert torch.equal(again.vae.quant_conv.weight, tsd.vae.quant_conv.weight)
    # a text tower given apart, in the HF layout
    te_sd = {"text_model." + k: v for k, v in tsd.text_encoder.model.state_dict().items()}
    no_te = {k: t(v) for k, v in ckpt.items() if not k.startswith("cond_stage_model.")}
    again = instantiate_from_config(_tiny_sd_model())
    again.load_state_dict(no_te, text_encoder_sd=te_sd)
    assert torch.equal(again.text_encoder.model.final_layer_norm.weight,
                       tsd.text_encoder.model.final_layer_norm.weight)
    with pytest.raises(RuntimeError, match="Missing key"):
        instantiate_from_config(_tiny_sd_model()).load_state_dict(
            {k: v for k, v in no_te.items() if "quant_conv" not in k})


@pytest.mark.parametrize("suffix", [".ckpt", ".safetensors"])
def test_load_weights_reads_checkpoint_files(pair, tmp_path, suffix):
    _, _, tsd = pair
    ckpt = {k: t(v) for k, v in _compvis_checkpoint(tsd).items()}
    path = str(tmp_path / ("w" + suffix))
    if suffix == ".ckpt":
        torch.save({"state_dict": ckpt, "global_step": 1}, path)
    else:
        pytest.importorskip("safetensors.torch").save_file(ckpt, path)
    fresh = instantiate_from_config(_tiny_sd_model()).load_weights(path)
    assert torch.equal(fresh.unet.out[2].weight, tsd.unet.out[2].weight)
    assert torch.equal(fresh.vae.decoder.conv_out.bias, tsd.vae.decoder.conv_out.bias)
    with pytest.raises(ValueError, match="unsupported weights file"):
        fresh.load_weights(str(tmp_path / "w.bin"))


def test_init_params_is_seeded_and_keeps_zero_layers():
    a = instantiate_from_config(_tiny_sd_model())
    b = instantiate_from_config(_tiny_sd_model())
    assert a.init_params(torch.Generator().manual_seed(5), img_size=IMG) is a
    b.init_params(torch.Generator().manual_seed(5))
    sa, sb = a.state_dict(), b.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    b.init_params(torch.Generator().manual_seed(6))
    assert not torch.equal(a.vae.decoder.conv_in.weight, b.vae.decoder.conv_in.weight)
    assert not a.unet.out[2].weight.any()                      # zero-initialised, as in JAX
    assert a.vae.encoder.norm_out.weight.eq(1).all() and not a.vae.encoder.norm_out.bias.any()
    w = a.text_encoder.model.encoder.layers[0].mlp.fc1.weight  # N(0, 1 / fan_in)
    assert abs(w.std().item() * 32 ** 0.5 - 1.0) < 0.1
    assert all(p.dtype == torch.float32 for p in a.parameters())


def test_defaults_scale_factor_and_unported_accelerators():
    sd = StableDiffusion(unet_config=None, vae_config=_tiny_sd_model()["params"]["vae_config"],
                         text_encoder_config=_tiny_sd_model()["params"]["text_encoder_config"],
                         scale_factor=0.5)
    assert sd.unet is None and sd.scale_factor == 0.5
    # ToMe and FreeU rebind the UNet's knobs, keep the parameters, chain
    full = instantiate_from_config(_tiny_sd_model())
    before = {k: v.clone() for k, v in full.state_dict().items()}
    assert full.set_tome(0.5, seed=3) is full and full.set_tome(0.6) is full
    u = full.unet
    assert (u.tome_ratio, u.tome_sx, u.tome_sy, u.tome_max_downsample, u.tome_seed) == (
        0.6, 2, 2, 1, 3)  # the knobs left out keep their values
    full.set_tome(0.0, max_downsample=2, seed=None)
    assert (u.tome_ratio, u.tome_max_downsample, u.tome_seed) == (0.0, 2, None)
    assert full.set_freeu((1.2, 1.4, 0.9, 0.2)) is full and u.freeu == (1.2, 1.4, 0.9, 0.2)
    assert full.set_freeu(None).unet.freeu is None
    with pytest.raises(ValueError, match="exactly"):
        full.set_freeu((1.2, 1.4, 0.9))
    after = full.state_dict()
    assert after.keys() == before.keys() and all(torch.equal(after[k], v)
                                                 for k, v in before.items())
    sd.text_encoder.tokenizer = lambda texts, **kw: {
        "input_ids": np.stack([_ids(x)[0] for x in texts])}
    with torch.no_grad():
        assert sd.text_encoder_encode(["a", "b"]).shape == (2, 16, 32)
