"""dmtpu_torch's SDXL modules against dmtpu's, in f32 on the CPU: the SDXL
options of ``SDUNetModel`` (each at a tiny size), the conditioner,
``concat_timestep_embedder_nd``, the wrapper built from
``tests/_tiny_fixtures.py::tiny_sdxl_config`` through the reference targets,
and the sgm checkpoint layout.

The JAX params are seeded random (``jax_random_params``: no layer is left at
zero) and carried across by the param bridge.  Tolerance: relative L2 error
at most 1e-4 (f32 sums in another order through a few layers).  The options
still refused are ``tests/test_torch_sd_unet.py::test_unported_options_raise``'s.
"""
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmtpu.models import sdxl as jsdxl
from dmtpu.models.stablediffusion import SDUNetModel as JaxUNet
from dmtpu.utils.config import instantiate_from_config as jax_instantiate
from dmtpu_torch.convert import (
    load_flax_params,
    sdxl_state_dict_from_flax,
    split_sdxl_checkpoint,
)
from dmtpu_torch.models.sdxl import SDXLConditioner, StableDiffusionXL, concat_timestep_embedder_nd
from dmtpu_torch.models.stablediffusion import SDUNetModel
from dmtpu_torch.utils.config import instantiate_from_config, load_config
from tests._tiny_fixtures import tiny_sdxl_config
from tests._torch_helpers import TINY_SD_UNET_CFG, jax_random_params, nhwc, t

ADM_IN = 12
# each SDXL option of SDUNetModel on the tiny SD UNet (levels 1 and 2, both
# with attention; 2 heads; context 24)
UNET_CASES = {
    "num_classes_int": dict(num_classes=10),
    "num_classes_continuous": dict(num_classes="continuous"),
    "num_classes_sequential": dict(num_classes="sequential", adm_in_channels=ADM_IN),
    "num_classes_timestep": dict(num_classes="timestep"),
    "per_level_depths_and_middle": dict(num_res_blocks=[1, 2], transformer_depth=[1, 2],
                                        transformer_depth_middle=3),
    "disable_self_attentions": dict(disable_self_attentions=[True, False],
                                    disable_middle_self_attn=True),
    "num_attention_blocks": dict(num_res_blocks=2, num_attention_blocks=[1, 2]),
    "disable_middle_transformer": dict(disable_middle_transformer=True),
    "linear_projections": dict(use_linear_in_transformer=True, num_head_channels=16),
    "softmax_xformers": dict(spatial_transformer_attn_type="softmax-xformers"),
}


def jax_sdxl_params(jw, img_size: int = 64, seed: int = 1) -> dict:
    """Seeded random params of a JAX ``StableDiffusionXL`` in its
    ``init_params`` layout ``{"unet", "vae", "conditioner": {"clip_l",
    "clip_g"}}`` (``jax_random_params`` for each part; bigG with its pooled
    path's ``text_projection``, as ``SDXLConditioner.init`` makes it)."""
    lat, ids = img_size // 8, jnp.zeros((1, 77), jnp.int32)
    u = jw.unet
    pooled = functools.partial(jw.conditioner.clip_g.init, output_layer="penultimate-nonorm",
                               return_pooled=True)
    return {
        "unet": jax_random_params(u, jnp.zeros((1, lat, lat, u.in_channels)),
                                  jnp.zeros((1,), jnp.int32), jnp.zeros((1, 77, u.context_dim)),
                                  jnp.zeros((1, u.adm_in_channels)), seed=seed),
        "vae": jax_random_params(jw.vae, jnp.zeros((1, img_size, img_size, 3)),
                                 jax.random.PRNGKey(0), seed=seed + 1),
        "conditioner": {
            "clip_l": jax_random_params(jw.conditioner.clip_l, ids, seed=seed + 2),
            "clip_g": jax_random_params(types.SimpleNamespace(init=pooled), ids, seed=seed + 3)},
    }


def rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _labels(opts, rs, b):
    kind = opts.get("num_classes")
    if kind is None:
        return None
    if isinstance(kind, int):
        return rs.randint(0, kind, (b,))
    if kind == "sequential":
        return rs.randn(b, ADM_IN).astype(np.float32)
    if kind == "continuous":  # a scalar label, such as a noise level
        return rs.rand(b).astype(np.float32)
    return (rs.rand(b) * 500).astype(np.float32)  # a timestep


@pytest.mark.parametrize("case", list(UNET_CASES))
def test_unet_option_matches_jax(case):
    opts = dict(TINY_SD_UNET_CFG, **UNET_CASES[case])
    rs = np.random.RandomState(len(case))
    x = rs.randn(2, 4, 8, 8).astype(np.float32)
    ts = np.array([3, 700])
    ctx = rs.randn(2, 7, 24).astype(np.float32)
    y = _labels(opts, rs, 2)
    jmodel = JaxUNet(**opts)
    jargs = [jnp.asarray(nhwc(x)), jnp.asarray(ts), jnp.asarray(ctx)]
    if y is not None:
        jargs.append(jnp.asarray(y))
    params = jax_random_params(jmodel, *jargs, seed=len(case))
    want = np.asarray(jmodel.apply(params, *jargs))
    tmodel = load_flax_params(SDUNetModel(**opts), params).eval()
    with torch.no_grad():
        got = tmodel(t(x), t(ts), t(ctx), y=None if y is None else t(y)).numpy()
    assert np.isfinite(got).all() and np.abs(want).max() > 0
    assert rel_l2(nhwc(got), want) <= 1e-4


def test_unet_structure_follows_the_options():
    """Upstream keys: ``label_emb.0.0`` for "sequential", ``label_emb.1.0``
    for "timestep", linear ``proj_in`` [C_inner, C], ``middle_block.2`` kept
    without the middle transformer, per-level depths."""
    seq = SDUNetModel(**dict(TINY_SD_UNET_CFG, **UNET_CASES["num_classes_sequential"],
                             **UNET_CASES["linear_projections"], num_res_blocks=[1, 2],
                             transformer_depth=[1, 2]), device="meta")
    keys = seq.state_dict().keys()
    assert {"label_emb.0.0.weight", "label_emb.0.2.weight"} <= set(keys)
    assert seq.state_dict()["label_emb.0.0.weight"].shape == (128, ADM_IN)
    assert seq.input_blocks[1][1].proj_in.weight.shape == (32, 32)
    assert len(seq.input_blocks[4][1].transformer_blocks) == 2
    assert len(seq.middle_block[1].transformer_blocks) == 2  # transformer_depth[-1]
    ts = SDUNetModel(**TINY_SD_UNET_CFG, num_classes="timestep", device="meta")
    assert "label_emb.1.2.weight" in ts.state_dict()
    mid = SDUNetModel(**TINY_SD_UNET_CFG, disable_middle_transformer=True, device="meta")
    assert isinstance(mid.middle_block[1], torch.nn.Identity)
    assert "middle_block.2.in_layers.0.weight" in mid.state_dict()
    fp16 = SDUNetModel(**TINY_SD_UNET_CFG, use_fp16=True, device="meta")
    bf16 = SDUNetModel(**TINY_SD_UNET_CFG, use_bf16=True, device="meta")
    assert fp16.torso_dtype == bf16.torso_dtype == torch.bfloat16
    assert SDUNetModel(**TINY_SD_UNET_CFG, device="meta").torso_dtype is None


def test_labels_are_required_and_checked():
    model = SDUNetModel(**TINY_SD_UNET_CFG, num_classes="sequential", adm_in_channels=ADM_IN)
    x, ts, ctx = torch.randn(1, 4, 8, 8), torch.zeros(1, dtype=torch.int64), torch.randn(1, 7, 24)
    with pytest.raises(ValueError, match="requires y"):
        model(x, ts, ctx)
    with pytest.raises(ValueError, match="adm_in_channels"):
        SDUNetModel(**TINY_SD_UNET_CFG, num_classes="sequential", device="meta")
    with pytest.raises(ValueError, match="num_classes"):
        SDUNetModel(**TINY_SD_UNET_CFG, num_classes="bogus", device="meta")


def test_y_passes_through_deepcache_tome_and_freeu():
    """A vector-conditioned UNet: the DeepCache full pass is the plain
    forward, the shallow pass with its cache too; ToMe and FreeU run on the
    same ``y`` and change the output; ``y`` changes it in every mode."""
    torch.manual_seed(0)
    model = SDUNetModel(**TINY_SD_UNET_CFG, num_classes="sequential",
                        adm_in_channels=ADM_IN).eval()
    for p in model.parameters():
        torch.nn.init.normal_(p, std=0.2)
    x, ctx = torch.randn(2, 4, 8, 8), torch.randn(2, 7, 24)
    ts, y = torch.tensor([5, 600]), torch.randn(2, ADM_IN)
    with torch.no_grad():
        plain = model(x, ts, ctx, y)
        out, u = model(x, ts, ctx, y, dc_skip=1)
        assert torch.equal(out, plain)
        assert torch.equal(model(x, ts, ctx, y, dc_skip=1, dc_cached=u)[0], plain)
        assert not torch.allclose(model(x, ts, ctx, y + 1), plain, atol=1e-5)
        for on, off in ((lambda: model.set_tome(0.5, max_downsample=2), lambda: model.set_tome(0)),
                        (lambda: model.set_freeu((1.1, 1.2, 0.9, 0.2)),
                         lambda: model.set_freeu(None))):
            on()
            got = model(x, ts, ctx, y)
            assert torch.isfinite(got).all() and not torch.allclose(got, plain, atol=1e-5)
            assert not torch.allclose(model(x, ts, ctx, y + 1), got, atol=1e-5)
            off()


def test_concat_timestep_embedder_nd_matches():
    rs = np.random.RandomState(3)
    for x in (rs.rand(3, 2) * 1024, rs.rand(4) * 10):
        want = np.asarray(jsdxl.concat_timestep_embedder_nd(jnp.asarray(x, jnp.float32), 16))
        got = concat_timestep_embedder_nd(torch.as_tensor(x, dtype=torch.float32), 16).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(config, JAX wrapper, its params, the port's wrapper with them)."""
    conf = load_config(tiny_sdxl_config(tmp_path_factory.mktemp("sdxl") / "sdxl.yaml"))
    jw = jax_instantiate(conf.model)
    params = jax_sdxl_params(jw)
    tw = instantiate_from_config(conf.model).eval()
    assert isinstance(tw, StableDiffusionXL) and isinstance(tw.conditioner, SDXLConditioner)
    tw.load_state_dict(sdxl_state_dict_from_flax(params))
    return conf, jw, params, tw


def _sizes(b):
    return [np.tile(np.array([[64.0, 48.0]], np.float32), (b, 1)), np.zeros((b, 2), np.float32),
            np.tile(np.array([[64.0, 64.0]], np.float32), (b, 1))]


def test_conditioner_matches(pair):
    _, jw, params, tw = pair
    rs = np.random.RandomState(5)
    tl, tg = rs.randint(0, 256, (2, 77)), rs.randint(0, 256, (2, 77))
    el, eg = rs.randint(0, 256, (2, 77)), rs.randint(0, 256, (2, 77))
    sizes = _sizes(2)
    (wc, wv), (wuc, wuv) = jw.conditioner.get_unconditional_conditioning(
        params["conditioner"], *map(jnp.asarray, (tl, tg, el, eg, *sizes)))
    with torch.no_grad():
        (c, v), (uc, uv) = tw.conditioner.get_unconditional_conditioning(
            *map(torch.from_numpy, (tl, tg, el, eg)), *sizes)
    assert c.shape == (2, 77, 96) and v.shape == (2, 160)
    for got, want in ((c, wc), (v, wv), (uv, wuv)):
        assert rel_l2(got.numpy(), want) <= 1e-4
    assert not uc.any() and np.asarray(wuc).max() == 0  # the text zeroed
    assert torch.equal(uv[:, 64:], v[:, 64:]) and not uv[:, :64].any()


def test_conditioner_composition_check_and_embed_dim():
    """The yaml's ``emb_models`` must be the base composition (the JAX error
    text); ``embed_dim`` comes from its ``outdim``."""
    tiny = dict(clip_l_overrides={"width": 32, "layers": 2, "heads": 4, "vocab_size": 64},
                clip_g_overrides={"width": 32, "layers": 2, "heads": 4, "vocab_size": 64,
                                  "projection_dim": 16})
    emb = [{"target": "sgm.modules.encoders.modules.FrozenCLIPEmbedder"},
           {"target": "sgm.modules.encoders.modules.FrozenOpenCLIPEmbedder2"}] + [
        {"target": "sgm.modules.encoders.modules.ConcatTimestepEmbedderND",
         "params": {"outdim": 8}}] * 3
    cond = SDXLConditioner(emb_models=emb, device="meta", **tiny)
    assert cond.embed_dim == 8 and cond.clip_g.text_projection.shape == (32, 16)
    with pytest.raises(ValueError) as got:
        SDXLConditioner(emb_models=emb[:4], device="meta", **tiny)
    with pytest.raises(ValueError) as want:
        jsdxl.SDXLConditioner(emb_models=emb[:4], **tiny)
    assert str(got.value) == str(want.value)


def test_wrapper_pieces_match(pair):
    _, jw, params, tw = pair
    rs = np.random.RandomState(6)
    x, ctx = rs.randn(2, 4, 8, 8).astype(np.float32), rs.randn(2, 77, 96).astype(np.float32)
    y, ts = rs.randn(2, 160).astype(np.float32), np.array([7, 900])
    want = np.asarray(jw.make_model_fn(params)(jnp.asarray(nhwc(x)), jnp.asarray(ts),
                                               cond=(jnp.asarray(ctx), jnp.asarray(y))))
    z = rs.randn(2, 4, 8, 8).astype(np.float32)
    want_img = np.asarray(jw.decode_latent(params, jnp.asarray(nhwc(z))))
    with torch.no_grad():
        got = tw.make_model_fn()(t(x), t(ts), cond=(t(ctx), t(y)), other=1)
        assert torch.equal(tw(t(x), t(ts), t(ctx), t(y)), got)
        img = tw.decode_latent(t(z))
    assert rel_l2(nhwc(got.numpy()), want) <= 1e-4
    assert img.shape == (2, 3, 64, 64) and rel_l2(nhwc(img.numpy()), want_img) <= 1e-4
    assert tw.scale_factor == jw.scale_factor == 0.13025
    # encode: the JAX posterior's moments, a sample scale_factor * (mean + std * noise)
    x = rs.randn(2, 3, 64, 64).astype(np.float32)
    moments = jw.vae.apply(params["vae"], jnp.asarray(nhwc(x)), method=jw.vae.encode_moments)
    mean, logvar = np.split(np.asarray(moments), 2, axis=-1)
    with torch.no_grad():
        z = tw.encode_latent(t(x), torch.Generator().manual_seed(0))
    noise = torch.randn(z.shape, generator=torch.Generator().manual_seed(0)).numpy()
    want_z = 0.13025 * (mean + np.exp(0.5 * np.clip(logvar, -30, 20)) * nhwc(noise))
    assert rel_l2(nhwc(z.numpy()), want_z) <= 1e-4


def _openclip_layout(tower_sd):
    """The port's bigG tower state dict in open_clip's layout (q, k, v fused
    into ``in_proj``), with the two extra leaves open_clip files carry."""
    out = {"logit_scale": torch.tensor(4.6), "attn_mask": torch.zeros(77, 77)}
    names = {"embeddings.token_embedding.weight": "token_embedding.weight",
             "embeddings.position_embedding.weight": "positional_embedding",
             "text_projection": "text_projection", "final_layer_norm.weight": "ln_final.weight",
             "final_layer_norm.bias": "ln_final.bias"}
    layers = {}
    for k, v in tower_sd.items():
        if k in names:
            out[names[k]] = v
            continue
        i, rest = k[len("encoder.layers."):].split(".", 1)
        base = f"transformer.resblocks.{i}."
        if rest.startswith("self_attn.") and rest.split(".")[1] in ("q_proj", "k_proj", "v_proj"):
            layers.setdefault((base, rest.rsplit(".", 1)[1]), {})[rest.split(".")[1]] = v
            continue
        rest = (rest.replace("self_attn.out_proj", "attn.out_proj").replace("layer_norm1", "ln_1")
                .replace("layer_norm2", "ln_2").replace("mlp.fc1", "mlp.c_fc")
                .replace("mlp.fc2", "mlp.c_proj"))
        out[base + rest] = v
    for (base, leaf), qkv in layers.items():
        out[f"{base}attn.in_proj_{leaf}"] = torch.cat([qkv["q_proj"], qkv["k_proj"],
                                                       qkv["v_proj"]])
    return out


def _sgm_checkpoint(tw):
    sd = {f"model.diffusion_model.{k}": v for k, v in tw.unet.state_dict().items()}
    sd.update({f"first_stage_model.{k}": v for k, v in tw.vae.state_dict().items()})
    sd.update({f"conditioner.embedders.0.transformer.text_model.{k}": v
               for k, v in tw.conditioner.clip_l.state_dict().items()})
    sd["conditioner.embedders.0.transformer.text_model.embeddings.position_ids"] = \
        torch.arange(77)[None]
    sd.update({f"conditioner.embedders.1.model.{k}": v
               for k, v in _openclip_layout(tw.conditioner.clip_g.state_dict()).items()})
    return sd


def test_sgm_checkpoint_loads_and_reproduces_the_outputs(pair):
    """An sgm-layout state dict assembled from the port's own modules (bigG in
    open_clip layout) splits, loads and gives the same outputs bit for bit;
    separate tower dicts take the place of the checkpoint's."""
    conf, _, _, tw = pair
    sd = _sgm_checkpoint(tw)
    parts = split_sdxl_checkpoint(sd)
    assert set(parts) == {"unet", "vae", "clip_l", "clip_g"}
    assert "text_projection" in parts["clip_g"] and "logit_scale" not in parts["clip_g"]
    fresh = instantiate_from_config(conf.model).eval().load_state_dict(sd)
    rs = np.random.RandomState(7)
    ids = torch.from_numpy(rs.randint(0, 256, (2, 77)))
    x, ts = torch.from_numpy(rs.randn(2, 4, 8, 8).astype(np.float32)), torch.tensor([1, 99])
    with torch.no_grad():
        for a, b in zip(fresh.conditioner(ids, ids, *_sizes(2)), tw.conditioner(ids, ids, *_sizes(2))):
            assert torch.equal(a, b)
        ctx, vec = tw.conditioner(ids, ids, *_sizes(2))
        assert torch.equal(fresh.unet_forward(x, ts, ctx, vec), tw.unet_forward(x, ts, ctx, vec))
        assert torch.equal(fresh.decode_latent(x), tw.decode_latent(x))
    # the towers apart: HF CLIP-L (with the prefix) and open_clip bigG
    no_text = {k: v for k, v in sd.items() if not k.startswith("conditioner.")}
    clip_l = {k[len("conditioner.embedders.0.transformer."):]: v for k, v in sd.items()
              if k.startswith("conditioner.embedders.0.")}
    clip_g = _openclip_layout(tw.conditioner.clip_g.state_dict())
    apart = instantiate_from_config(conf.model).load_state_dict(no_text, clip_l_sd=clip_l,
                                                                clip_g_sd=clip_g)
    for name, value in tw.state_dict().items():
        assert torch.equal(apart.state_dict()[name], value), name
    assert split_sdxl_checkpoint(no_text)["clip_g"] is None


def test_init_params_is_seeded_on_the_module_s_device(pair):
    conf = pair[0]
    a = instantiate_from_config(conf.model).init_params(torch.Generator().manual_seed(3))
    b = instantiate_from_config(conf.model).init_params(torch.Generator().manual_seed(3))
    for (name, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(p, q), name
    assert not a.unet.out[2].weight.any()  # zero-initialised layers stay zero
    assert a.conditioner.clip_g.text_projection.std() > 0
    meta = instantiate_from_config(conf.model, device="meta")
    assert {p.device.type for p in meta.parameters()} == {"meta"}
