"""dmtpu_torch.models.lora and the LoRA CLIs against dmtpu's (the twins of
``tests/test_lora.py``'s five cases).

The JAX package keys an adapter by its Flax param path
(``params.input_blocks__1__1.….to_q.kernel``), the port by the torch module
path (``input_blocks.1.1.….to_q``); the arrays ``a`` [d_in, r] and ``b``
[r, d_out] carry over unchanged.  Tolerances: the adapters' gradients 1e-4
relative L2 against ``jax.grad`` (f32, sums in another order through the
tiny UNet); a merged weight 1e-6 against the JAX ``apply_lora`` (one f32
product and add).
"""
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmtpu.models import lora as jlora
from dmtpu.models.stablediffusion import SDUNetModel as JaxUNet
from dmtpu_torch.convert import load_flax_params
from dmtpu_torch.models.lora import (
    DEFAULT_TARGETS,
    apply_lora,
    init_lora,
    lora_param_count,
    lora_scale,
    lora_weights,
    merge_lora,
)
from dmtpu_torch.models.stablediffusion import SDUNetModel
from dmtpu_torch.parallel import TrainState
from dmtpu_torch.scripts import merge_lora as merge_cli
from dmtpu_torch.scripts import train_sd
from dmtpu_torch.utils import checkpoint as ckpt_lib
from dmtpu_torch.utils.config import instantiate_from_config, load_config
from dmtpu_torch.utils.optim import adamw
from tests._tiny_fixtures import tiny_sd_train_config
from tests._torch_helpers import TINY_SD_UNET_CFG, char_tokenizer_dir, nhwc, perturb, t


def torch_path(jax_key: str) -> str:
    """``params.input_blocks__1__1.….to_out__0.kernel`` -> ``input_blocks.1.1.….to_out.0``"""
    return jax_key.removeprefix("params.").removesuffix(".kernel").replace("__", ".")


@pytest.fixture(scope="module")
def tiny_unet():
    """(JAX UNet, its perturbed params, the port's UNet with them, inputs)."""
    rs = np.random.RandomState(0)
    x = rs.randn(2, 4, 8, 8).astype(np.float32)
    ts = np.array([3, 7])
    ctx = rs.randn(2, 7, 24).astype(np.float32)
    jmodel = JaxUNet(**TINY_SD_UNET_CFG)
    params = perturb(jax.jit(jmodel.init)(jax.random.PRNGKey(1), jnp.asarray(nhwc(x)),
                                          jnp.asarray(ts), jnp.asarray(ctx)), 2, std=0.02)
    model = load_flax_params(SDUNetModel(**TINY_SD_UNET_CFG), params).requires_grad_(False)
    return jmodel, params, model, (x, ts, ctx)


def _forward(model, weights, inputs):
    x, ts, ctx = inputs
    return torch.func.functional_call(model, weights, (t(x), torch.from_numpy(ts)),
                                      {"context": t(ctx)})


def test_init_targets_and_identity(tiny_unet):
    jmodel, params, model, inputs = tiny_unet
    lora = init_lora(model, torch.Generator().manual_seed(2), rank=4)
    want = jlora.init_lora(params, jax.random.PRNGKey(2), rank=4)
    assert sorted(lora.paths) == sorted(torch_path(k) for k in want)
    assert len(lora.paths) % len(DEFAULT_TARGETS) == 0
    # both names of the output projection select the same layers
    assert init_lora(model, rank=4, targets=("to_out.0",)).paths == \
        init_lora(model, rank=4, targets=("to_out__0",)).paths
    adapters = dict(lora.named_parameters())
    for path in lora.paths:
        a, b = adapters[path + ".a"], adapters[path + ".b"]
        w = model.get_parameter(path + ".weight")
        assert a.shape == (w.shape[1], 4) and b.shape == (4, w.shape[0])
        assert not b.any() and a.any()  # b zero-initialised
    base = dict(model.named_parameters())
    with torch.no_grad():
        got = _forward(model, lora_weights(base, adapters, lora_scale(4, alpha=8)), inputs)
        torch.testing.assert_close(got, _forward(model, {}, inputs), rtol=0, atol=0)
    assert lora_param_count(adapters) < sum(p.numel() for p in model.parameters()) / 10
    assert lora_scale(4) == 1.0 and lora_scale(16, 16) == 1.0 and lora_scale(4, 8) == 2.0


def test_adapter_gradients_match_jax_and_the_base_gets_none(tiny_unet):
    jmodel, params, model, (x, ts, ctx) = tiny_unet
    jl = jax.tree.map(lambda v: v + 0.1 * jax.random.normal(jax.random.PRNGKey(9), v.shape),
                      jlora.init_lora(params, jax.random.PRNGKey(3), rank=2))

    def jloss(lo):
        out = jmodel.apply(jlora.apply_lora(params, lo, 1.5), jnp.asarray(nhwc(x)),
                           jnp.asarray(ts), jnp.asarray(ctx))
        return jnp.mean(out ** 2)

    jgrads = jax.device_get(jax.jit(jax.grad(jloss))(jl))
    lora = init_lora(model, rank=2)
    with torch.no_grad():
        for key, ab in jl.items():
            for leaf in ("a", "b"):
                lora.get_parameter(f"{torch_path(key)}.{leaf}").copy_(t(np.asarray(ab[leaf])))
    adapters = dict(lora.named_parameters())
    out = _forward(model, lora_weights(dict(model.named_parameters()), adapters, 1.5),
                   (x, ts, ctx))
    out.square().mean().backward()
    assert all(p.grad is None for p in model.parameters())
    diff = norm = 0.0
    for key, g in jgrads.items():
        for leaf in ("a", "b"):
            got = adapters[f"{torch_path(key)}.{leaf}"].grad.numpy()
            diff += float(np.square(got - g[leaf]).sum())
            norm += float(np.square(g[leaf]).sum())
    assert norm > 0 and (diff / norm) ** 0.5 <= 1e-4
    assert merge_lora is apply_lora


def test_apply_lora_rejects_stale_keys(tiny_unet):
    _, _, model, _ = tiny_unet
    with pytest.raises(ValueError, match="not in params"):
        apply_lora(dict(model.named_parameters()),
                   {"nope.a": torch.zeros(1, 1), "nope.b": torch.zeros(1, 1)})


@pytest.fixture(scope="module")
def lora_run(tmp_path_factory):
    """The LoRA CLI's run on the tiny fixture config (rank 4, alpha 8)."""
    d = tmp_path_factory.mktemp("lora")
    cfg = tiny_sd_train_config(d / "conf.yaml", char_tokenizer_dir(d / "tokenizer"),
                               lora={"rank": 4, "alpha": 8})
    exp = str(d / "exp")
    train_sd.main(["-c", cfg, "-e", exp, "-ni", "--device", "cpu"])
    return d, cfg, exp


def test_train_sd_lora_end_to_end(lora_run):
    _, _, exp = lora_run
    log = open(glob.glob(os.path.join(exp, "output-*.log"))[0]).read()
    assert "LoRA fine-tune: rank=4 scale=2" in log and "End of training" in log
    assert glob.glob(os.path.join(exp, "samples", "*.png"))
    ckpt = os.path.join(exp, "ckpt", "step000002")
    size = sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(ckpt) for f in fs)
    assert size < 5e6, f"LoRA checkpoint unexpectedly large: {size}"
    blob = ckpt_lib.load_checkpoint_host(ckpt)
    assert blob["model"] and all(k.endswith((".a", ".b")) for k in blob["model"])
    assert blob["ema"]["shadow"].keys() == blob["model"].keys()


def test_merge_lora_cli(lora_run, tmp_path):
    d, cfg, exp = lora_run
    out = str(tmp_path / "merged.pt")
    merge_cli.main(["-c", cfg, "--lora", os.path.join(exp, "ckpt", "step000002"), "--out", out,
                    "--device", "cpu"])
    conf = load_config(cfg)
    merged = instantiate_from_config(conf.model).load_weights(out)
    base = instantiate_from_config(conf.model).init_params(
        torch.Generator().manual_seed(conf.seed))
    # the tiny demo UNet's zero output head stops every gradient, so the
    # adapters keep b = 0 and the merge is exactly the same-seed base: the
    # training left the base alone
    for k, v in base.state_dict().items():
        assert torch.equal(merged.state_dict()[k], v), k

    # non-trivial adapters, merged by the CLI, against the JAX apply_lora
    lora = init_lora(base.unet, torch.Generator().manual_seed(5), rank=4)
    with torch.no_grad():
        for p in lora.parameters():
            p.add_(0.1)
    state = TrainState.create(lora, adamw(lora.parameters(), lr=1e-4), ema_decay=None)
    ck2 = ckpt_lib.save_checkpoint(str(tmp_path / "ck2"), 1, state)
    out2 = str(tmp_path / "merged2.pt")
    merge_cli.main(["-c", cfg, "--lora", ck2, "--out", out2, "--device", "cpu"])
    merged2 = instantiate_from_config(conf.model).load_weights(out2)
    adapters = dict(lora.named_parameters())
    tree = {path: {"kernel": base.unet.get_parameter(path + ".weight").detach().numpy().T}
            for path in lora.paths}
    want = jlora.apply_lora(tree, {f"{p}.kernel": {"a": adapters[p + ".a"].detach().numpy(),
                                                    "b": adapters[p + ".b"].detach().numpy()}
                                   for p in lora.paths}, lora_scale(4, 8))
    for path in lora.paths:
        np.testing.assert_allclose(merged2.unet.get_parameter(path + ".weight").detach().numpy(),
                                   np.asarray(want[path]["kernel"]).T, rtol=0, atol=1e-6)
    assert not torch.equal(merged2.unet.get_parameter(lora.paths[0] + ".weight"),
                           base.unet.get_parameter(lora.paths[0] + ".weight"))
    with torch.no_grad():  # and the merged model runs
        outp = merged2.unet(torch.zeros(1, 4, 4, 4), torch.zeros(1, dtype=torch.int64),
                            context=torch.zeros(1, 16, 32))
    assert torch.isfinite(outp).all()


def test_merge_lora_cli_takes_a_jax_npz_base(lora_run, tmp_path):
    """``--base`` is the JAX package's ``.npz`` (seeded random params of the
    tiny stack, drawn without running the inits): the merged UNet is the JAX
    ``merge_lora`` of that file's UNet (1e-6), the VAE and text tower are
    the file's, as the bridge loads them."""
    import types

    from dmtpu.utils.config import instantiate_from_config as jax_instantiate
    from tests._torch_helpers import jax_random_params

    _, cfg, _ = lora_run
    conf = load_config(cfg)
    jsd = jax_instantiate(conf.model)
    size, max_len = conf.data.params.img_size, jsd.text_encoder.max_length
    lat = size // 8
    vae = types.SimpleNamespace(init=lambda k, x: jsd.vae.init(k, x, rng=k))
    params = {
        "unet": jax_random_params(jsd.unet, jnp.zeros((1, lat, lat, jsd.unet.in_channels)),
                                  jnp.zeros((1,), jnp.int32),
                                  jnp.zeros((1, max_len, jsd.unet.context_dim)), seed=1),
        "vae": jax_random_params(vae, jnp.zeros((1, size, size, 3)), seed=2),
        "text_encoder": jax_random_params(jsd.text_encoder.model,
                                          jnp.ones((1, max_len), jnp.int32), seed=3)}
    npz = str(tmp_path / "base.npz")
    np.savez(npz, params=params)
    base = instantiate_from_config(conf.model).load_weights(npz)
    lora = init_lora(base.unet, torch.Generator().manual_seed(6), rank=4)
    with torch.no_grad():
        for p in lora.parameters():
            p.add_(0.1)
    ck = ckpt_lib.save_checkpoint(str(tmp_path / "ck"), 1, TrainState.create(
        lora, adamw(lora.parameters(), lr=1e-4), ema_decay=None))
    out = str(tmp_path / "merged.pt")
    merge_cli.main(["-c", cfg, "--lora", ck, "--base", npz, "--out", out, "--device", "cpu"])
    merged = instantiate_from_config(conf.model).load_weights(out)

    adapters = dict(lora.named_parameters())
    jax_keys = {torch_path(k): k for k in _kernel_keys(params["unet"])}
    want_unet = jlora.merge_lora(params["unet"], {
        jax_keys[p]: {"a": adapters[p + ".a"].detach().numpy(),
                      "b": adapters[p + ".b"].detach().numpy()} for p in lora.paths},
        lora_scale(4, 8))
    want = load_flax_params(SDUNetModel(**dict(conf.model.params.unet_config.params)),
                            want_unet).state_dict()
    got = merged.state_dict()
    for k, v in want.items():
        np.testing.assert_allclose(got["unet." + k].numpy(), v.numpy(), rtol=0, atol=1e-6,
                                   err_msg=k)
    for k, v in base.state_dict().items():
        if not k.startswith("unet."):
            assert torch.equal(got[k], v), k
    assert not torch.equal(got[f"unet.{lora.paths[0]}.weight"],
                           base.state_dict()[f"unet.{lora.paths[0]}.weight"])


def _kernel_keys(tree, prefix=""):
    """The dotted paths of a Flax tree's ``kernel`` leaves."""
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if hasattr(v, "items"):
            yield from _kernel_keys(v, path + ".")
        elif k == "kernel":
            yield path
