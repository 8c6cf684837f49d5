"""dmtpu_torch's AutoencoderKL and its blocks against dmtpu's, f32 on the CPU.

Small widths (ch 32, 32 groups of one channel, or ch 64): the JAX params are
perturbed with seeded normals and loaded through the param bridge; inputs are
NCHW here and NHWC there.  Tolerance rtol/atol 2e-4 on values of order one:
f32 convolutions summed in another order through up to ~25 layers.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmtpu.convert.sd import diffusers_vae_to_compvis as jax_diffusers_vae_to_compvis
from dmtpu.models import pesser as jp
from dmtpu.models.stablediffusion import autoencoder as ja
from dmtpu_torch.convert import load_flax_params, state_dict_from_flax
from dmtpu_torch.convert.sd import diffusers_vae_to_compvis
from dmtpu_torch.models import pesser as tp
from dmtpu_torch.models.stablediffusion import autoencoder as ta
from tests._torch_helpers import nhwc, perturb, t

TOL = dict(rtol=2e-4, atol=2e-4)


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("cin,cout,conv_shortcut", [(32, 32, False), (32, 64, False),
                                                    (32, 64, True)])
def test_pesser_resnet_block_matches(cin, cout, conv_shortcut):
    x, temb = _x((2, cin, 8, 8)), _x((2, 24), 1)
    jmod = jp._ResnetBlock(cout, conv_shortcut=conv_shortcut)
    params = perturb(jmod.init(jax.random.PRNGKey(0), jnp.asarray(nhwc(x)), jnp.asarray(temb)), 2)
    want = np.asarray(jmod.apply(params, jnp.asarray(nhwc(x)), jnp.asarray(temb)))
    tmod = load_flax_params(tp._ResnetBlock(cin, cout, 24, conv_shortcut=conv_shortcut), params)
    with torch.no_grad():
        got = tmod(t(x), t(temb)).numpy()
    np.testing.assert_allclose(nhwc(got), want, **TOL)


def test_pesser_attn_block_matches():
    x = _x((2, 64, 6, 5))
    jmod = jp._AttnBlock()
    params = perturb(jmod.init(jax.random.PRNGKey(0), jnp.asarray(nhwc(x))), 3)
    want = np.asarray(jmod.apply(params, jnp.asarray(nhwc(x))))
    tmod = load_flax_params(tp._AttnBlock(64), params)
    with torch.no_grad():
        got = tmod(t(x)).numpy()
    np.testing.assert_allclose(nhwc(got), want, **TOL)


@pytest.mark.parametrize("name,with_conv,shape", [
    ("_Downsample", True, (2, 32, 8, 8)), ("_Downsample", True, (2, 32, 7, 9)),
    ("_Downsample", False, (2, 32, 8, 8)), ("_Upsample", True, (2, 32, 5, 4)),
    ("_Upsample", False, (2, 32, 5, 4)),
])
def test_pesser_resampling_matches(name, with_conv, shape):
    """The asymmetric (0, 1) padding of the stride-2 conv, odd sizes too, and
    nearest-neighbour upsampling."""
    x = _x(shape)
    jmod = getattr(jp, name)(with_conv)
    params = perturb(jmod.init(jax.random.PRNGKey(0), jnp.asarray(nhwc(x))), 4)
    want = np.asarray(jmod.apply(params, jnp.asarray(nhwc(x))))
    tmod = getattr(tp, name)(shape[1], with_conv)
    if with_conv:
        load_flax_params(tmod, params)
    with torch.no_grad():
        got = tmod(t(x)).numpy()
    assert got.shape[2:] == want.shape[1:3]
    np.testing.assert_allclose(nhwc(got), want, **TOL)


VAE_CASES = [
    dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(), resolution=16),
    dict(ch=32, ch_mult=(1, 2, 2), num_res_blocks=2, attn_resolutions=(8,), resolution=16),
]


@pytest.mark.parametrize("cfg", VAE_CASES)
def test_encoder_and_decoder_match(cfg):
    side = 16 // 2 ** (len(cfg["ch_mult"]) - 1)
    x, z = _x((2, 3, 16, 16)), _x((2, 4, side, side), 1)
    jenc = ja.Encoder(z_channels=4, **cfg)
    params = perturb(jenc.init(jax.random.PRNGKey(0), jnp.asarray(nhwc(x))), 5)
    want = np.asarray(jenc.apply(params, jnp.asarray(nhwc(x))))
    tenc = load_flax_params(ta.Encoder(z_channels=4, **cfg), params)
    with torch.no_grad():
        got = tenc(t(x)).numpy()
    assert got.shape == (2, 8) + z.shape[2:]
    np.testing.assert_allclose(nhwc(got), want, **TOL)

    jdec = ja.Decoder(out_ch=3, z_channels=4, **cfg)
    params = perturb(jdec.init(jax.random.PRNGKey(0), jnp.asarray(nhwc(z))), 6)
    want = np.asarray(jdec.apply(params, jnp.asarray(nhwc(z))))
    tdec = load_flax_params(ta.Decoder(out_ch=3, z_channels=4, **cfg), params)
    with torch.no_grad():
        got = tdec(t(z)).numpy()
    assert got.shape == (2, 3, 16, 16)
    np.testing.assert_allclose(nhwc(got), want, **TOL)


def test_decoder_tanh_out():
    z = _x((1, 4, 4, 4))
    cfg = dict(ch=32, out_ch=3, z_channels=4, ch_mult=(1,), num_res_blocks=1, resolution=4)
    a, b = ta.Decoder(**cfg), ta.Decoder(tanh_out=True, **cfg)
    b.load_state_dict(a.state_dict())
    with torch.no_grad():
        torch.testing.assert_close(b(t(z)), torch.tanh(a(t(z))))


def _vae_pair(cfg, seed=7):
    jvae = ja.AutoencoderKL(embed_dim=4, z_channels=4, **cfg)
    x = _x((2, 3, 16, 16), seed)
    params = perturb(jvae.init(jax.random.PRNGKey(0), jnp.asarray(nhwc(x)),
                               rng=jax.random.PRNGKey(1)), seed + 1)
    tvae = load_flax_params(ta.AutoencoderKL(embed_dim=4, z_channels=4, **cfg), params).eval()
    return jvae, params, tvae, x


@pytest.mark.parametrize("cfg", VAE_CASES)
def test_autoencoder_encode_decode_forward_match(cfg):
    jvae, params, tvae, x = _vae_pair(cfg)
    want_m = np.asarray(jvae.apply(params, jnp.asarray(nhwc(x)), method=jvae.encode_moments))
    with torch.no_grad():
        got_m = tvae.encode_moments(t(x))
        assert torch.equal(tvae.encode(t(x)).mode(), got_m.chunk(2, dim=1)[0])
    np.testing.assert_allclose(nhwc(got_m.numpy()), want_m, **TOL)

    z = _x((2, 4) + tuple(got_m.shape[2:]), 9)
    want_d = np.asarray(jvae.apply(params, jnp.asarray(nhwc(z)), method=jvae.decode))
    with torch.no_grad():
        got_d = tvae.decode(t(z)).numpy()
    np.testing.assert_allclose(nhwc(got_d), want_d, **TOL)

    # the whole module at the posterior's mode (the two frameworks draw other noise)
    want_r, want_mm = jvae.apply(params, jnp.asarray(nhwc(x)), sample_posterior=False)
    with torch.no_grad():
        got_r, got_mm = tvae(t(x), sample_posterior=False)
        sampled, _ = tvae(t(x), torch.Generator().manual_seed(0))
    np.testing.assert_allclose(nhwc(got_r.numpy()), np.asarray(want_r), **TOL)
    np.testing.assert_allclose(nhwc(got_mm.numpy()), np.asarray(want_mm), **TOL)
    assert sampled.shape == got_r.shape and not torch.equal(sampled, got_r)


def test_diagonal_gaussian_matches_with_given_noise():
    moments = 0.7 * _x((2, 8, 4, 4), 11)
    moments[0, 4, 0, 0], moments[1, 5, 1, 1] = 40.0, -50.0  # the log-variance is clipped
    # the noise the port draws from seed 12, handed to the JAX arithmetic
    noise = torch.randn((2, 4, 4, 4), generator=torch.Generator().manual_seed(12)).numpy()
    other = 0.5 * _x((2, 8, 4, 4), 13)
    jd, jo = ja.DiagonalGaussianDistribution(jnp.asarray(nhwc(moments))), \
        ja.DiagonalGaussianDistribution(jnp.asarray(nhwc(other)))
    td, to = ta.DiagonalGaussianDistribution(t(moments)), ta.DiagonalGaussianDistribution(t(other))
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(nhwc(td.sample(torch.Generator().manual_seed(12)).numpy()),
                               np.asarray(jd.mean + jd.std * nhwc(noise)), **tol)
    np.testing.assert_allclose(nhwc(td.mode().numpy()), np.asarray(jd.mode()), **tol)
    np.testing.assert_allclose(td.kl().numpy(), np.asarray(jd.kl()), rtol=1e-5)
    np.testing.assert_allclose(td.kl(to).numpy(), np.asarray(jd.kl(jo)), rtol=1e-5)
    # from a generator: the same seed gives the same sample, of unit-ish spread
    a = td.sample(torch.Generator().manual_seed(3))
    assert torch.equal(a, td.sample(torch.Generator().manual_seed(3)))
    det = ta.DiagonalGaussianDistribution(t(moments), deterministic=True)
    assert torch.equal(det.sample(), det.mean) and det.kl().item() == 0.0


def _diffusers_keys(compvis_sd, n_levels, legacy):
    """A diffusers-layout copy of a CompVis VAE state dict (the inverse of
    the renames, written out by hand for the test)."""
    names = ({"norm": "group_norm", "q": "query", "k": "key", "v": "value",
              "proj_out": "proj_attn"} if legacy else
             {"norm": "group_norm", "q": "to_q", "k": "to_k", "v": "to_v",
              "proj_out": "to_out.0"})
    out = {}
    for k, v in compvis_sd.items():
        nk = k.replace("mid.block_1", "mid_block.resnets.0").replace(
            "mid.block_2", "mid_block.resnets.1")
        if ".mid.attn_1." in nk:
            part = nk.split(".attn_1.")[1].split(".")[0]
            nk = nk.replace(f"mid.attn_1.{part}.", f"mid_block.attentions.0.{names[part]}.")
            if part != "norm" and nk.endswith("weight"):
                v = v[:, :, 0, 0]
        nk = nk.replace(".downsample.conv", ".downsamplers.0.conv").replace(
            ".upsample.conv", ".upsamplers.0.conv")
        nk = nk.replace(".block.", ".resnets.").replace(".nin_shortcut.", ".conv_shortcut.")
        nk = nk.replace("encoder.down.", "encoder.down_blocks.")
        if "decoder.up." in nk:
            i = int(nk.split("decoder.up.")[1].split(".")[0])
            nk = nk.replace(f"decoder.up.{i}.", f"decoder.up_blocks.{n_levels - 1 - i}.")
        nk = nk.replace("norm_out", "conv_norm_out")
        out[nk] = v
    return out


@pytest.mark.parametrize("legacy", [False, True])
def test_diffusers_vae_to_compvis_matches_the_jax_copy_and_loads(legacy):
    cfg = VAE_CASES[1]
    _, params, tvae, x = _vae_pair(cfg)
    compvis = {k: v.numpy() for k, v in state_dict_from_flax(params).items()}
    diffusers = _diffusers_keys(compvis, len(cfg["ch_mult"]), legacy)
    assert set(diffusers) != set(compvis)
    want = jax_diffusers_vae_to_compvis(diffusers)
    got = diffusers_vae_to_compvis(diffusers)
    assert sorted(got) == sorted(want) == sorted(compvis)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # torch tensors pass through the same renames and load strictly
    fresh = ta.AutoencoderKL(embed_dim=4, z_channels=4, **cfg)
    fresh.load_state_dict(diffusers_vae_to_compvis({k: t(v) for k, v in diffusers.items()}),
                          strict=True)
    with torch.no_grad():
        torch.testing.assert_close(fresh.encode_moments(t(x)), tvae.encode_moments(t(x)))
