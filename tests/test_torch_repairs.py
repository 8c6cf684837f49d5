"""Three faults of the port, each repaired and held here.

- F1: ``EMAState.create`` / ``TrainState.create`` take the EMA dtype by the
  name a config gives (``ema_dtype: bfloat16``), as the JAX package does.
- F2: a CompVis SD2.x checkpoint, whose open_clip text tower carries
  ``text_projection`` and ``logit_scale`` beside a tower without a
  projection, loads into ``StableDiffusion`` and gives the JAX wrapper's text
  embeddings (1e-5 relative L2: f32 on both sides, sums in another order
  through two layers); a missing leaf still raises.
- F3: dropout inside ``make_train_step`` draws from a stream that is a
  function of (seed, step), and the caller's global RNG is left as it was.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmtpu.utils.config import instantiate_from_config as jax_instantiate
from dmtpu_torch.convert import load_flax_params, state_dict_from_flax
from dmtpu_torch.diffusions import DDPM
from dmtpu_torch.models.ema import EMAState
from dmtpu_torch.models.stablediffusion import SDUNetModel
from dmtpu_torch.parallel import TrainState, make_train_step
from dmtpu_torch.utils.config import instantiate_from_config
from tests._tiny_fixtures import _tiny_sd_model
from tests._torch_helpers import TINY_SD_UNET_CFG, jax_sd_params, t


@pytest.mark.parametrize("name,want", [("bfloat16", torch.bfloat16), ("bf16", torch.bfloat16),
                                       ("float32", torch.float32), ("f32", torch.float32),
                                       (None, torch.float32)])
def test_ema_dtype_by_name(name, want):
    torch.manual_seed(0)
    model = torch.nn.Linear(6, 3)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    by_name = TrainState.create(model, opt, ema_decay=0.99, ema_dtype=name).ema
    by_dtype = EMAState.create(dict(model.named_parameters()), 0.99,
                               dtype=want if name else None)
    for key, s in by_name.shadow.items():
        assert s.dtype == want
        assert torch.equal(s, by_dtype.shadow[key])
    with pytest.raises(ValueError, match="unknown dtype name"):
        EMAState.create(dict(model.named_parameters()), dtype="half-ish")


def _openclip_tiny_conf():
    conf = _tiny_sd_model()
    conf["params"]["text_encoder_config"] = {
        "target": "dmtpu.models.stablediffusion.FrozenOpenCLIPEmbedder",
        "params": {"max_length": 16, "config_overrides": {
            "width": 32, "layers": 2, "heads": 4, "vocab_size": 256}}}
    return conf


def _openclip_layout(hf: dict, rs) -> dict:
    """An HF-layout CLIP text tower in open_clip's layout (fused in_proj),
    with the pooled path's ``text_projection`` and ``logit_scale``."""
    out = {"token_embedding.weight": hf["embeddings.token_embedding.weight"],
           "positional_embedding": hf["embeddings.position_embedding.weight"],
           "ln_final.weight": hf["final_layer_norm.weight"],
           "ln_final.bias": hf["final_layer_norm.bias"],
           "text_projection": rs.randn(32, 16).astype(np.float32),
           "logit_scale": np.array(4.6, np.float32)}
    rename = {"self_attn.out_proj": "attn.out_proj", "layer_norm1": "ln_1",
              "layer_norm2": "ln_2", "mlp.fc1": "mlp.c_fc", "mlp.fc2": "mlp.c_proj"}
    for layer in range(2):
        src = f"encoder.layers.{layer}."
        dst = f"transformer.resblocks.{layer}."
        for leaf in ("weight", "bias"):
            out[dst + f"attn.in_proj_{leaf}"] = np.concatenate(
                [hf[src + f"self_attn.{p}_proj.{leaf}"] for p in "qkv"])
            for a, b in rename.items():
                out[dst + f"{b}.{leaf}"] = hf[src + f"{a}.{leaf}"]
    return out


def test_compvis_sd2_checkpoint_with_text_projection_loads():
    conf = _openclip_tiny_conf()
    jsd = jax_instantiate(conf)
    params = {name: p["params"] for name, p in jax_sd_params(jsd, 64).items()}
    rs = np.random.RandomState(0)
    ckpt = {}
    for prefix, name in (("model.diffusion_model.", "unet"), ("first_stage_model.", "vae")):
        ckpt.update({prefix + k: v.numpy() for k, v in state_dict_from_flax(params[name]).items()})
    hf = {k: v.numpy() for k, v in state_dict_from_flax(params["text_encoder"]).items()}
    ckpt.update({"cond_stage_model.model." + k: v for k, v in _openclip_layout(hf, rs).items()})

    jparams = jsd.load_state_dict(ckpt)
    tsd = instantiate_from_config(conf).eval()
    assert tsd.load_state_dict({k: torch.from_numpy(v) for k, v in ckpt.items()}) is tsd
    assert not hasattr(tsd.text_encoder.model, "text_projection")
    ids = np.random.RandomState(1).randint(0, 256, (2, 16))
    want = np.asarray(jax.jit(jsd.text_encoder_encode_tokens)(jparams, jnp.asarray(ids)))
    with torch.no_grad():
        got = tsd.text_encoder_encode_tokens(torch.from_numpy(ids)).numpy()
    assert got.shape == (2, 16, 32)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 1e-5
    # the tower's own leaves are still all required
    lacking = {k: torch.from_numpy(v) for k, v in ckpt.items()
               if k != "cond_stage_model.model.transformer.resblocks.1.ln_2.weight"}
    with pytest.raises(RuntimeError, match="Missing key"):
        instantiate_from_config(conf).load_state_dict(lacking)


def test_train_step_dropout_is_a_function_of_seed_and_step():
    rs = np.random.RandomState(0)
    model = SDUNetModel(**TINY_SD_UNET_CFG, dropout=0.1).train()
    with torch.no_grad():  # non-zero everywhere, or the zero layers hide the dropout
        for p in model.parameters():
            p.add_(torch.from_numpy(0.05 * rs.randn(*p.shape).astype(np.float32)))
    batch = {"image": t(rs.randn(2, 4, 8, 8).astype(np.float32)),
             "eps": t(rs.randn(2, 4, 8, 8).astype(np.float32)),
             "t": torch.tensor([10, 600]), "context": t(rs.randn(2, 7, 24).astype(np.float32))}
    diffuser = DDPM(total_steps=1000)

    def loss_fn(b, generator):  # t and eps fixed: only the dropout masks vary
        return diffuser.loss_func(model, b["image"], b["t"], eps=b["eps"],
                                  model_kwargs={"context": b["context"]})

    # lr 0: the weights stay, so each step starts from the same state
    state = TrainState.create(model, torch.optim.SGD(model.parameters(), lr=0.0), ema_decay=None)
    step = make_train_step(loss_fn, seed=3)

    def run(at: int, global_seed: int):
        torch.manual_seed(global_seed)
        before = torch.random.get_rng_state()
        state.step = at
        loss = step(state, batch)["loss"]
        assert torch.equal(torch.random.get_rng_state(), before)
        return loss, [p.grad.clone() for p in model.parameters()]

    loss0, grads0 = run(0, 1)
    again, grads_again = run(0, 2)
    assert torch.equal(loss0, again)
    assert all(torch.equal(a, b) for a, b in zip(grads0, grads_again))
    loss1, _ = run(1, 1)
    assert not torch.equal(loss0, loss1)
    model.eval()  # without dropout, the step index changes nothing
    assert torch.equal(run(0, 1)[0], run(1, 1)[0])
