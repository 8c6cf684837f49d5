"""The port's data parallelism (``dmtpu_torch/parallel/{mesh,train}.py``,
``scripts/_common.py::DataParallelSampler``) on gloo ranks of the CPU, the
cases of ``tests/test_parallel.py``.

The ranks are processes started by ``tests/_torch_dist.py`` (one thread
each); what they run is ``tests/_torch_parallel_workers.py``; the one-rank
runs and the JAX package run in this process.  The tiny UNet of
``tests/test_parallel.py`` with dropout off (a rank draws its own dropout
masks, so only a model without dropout can give the one-rank numbers).

- A data-parallel step over 1 (a one-rank group), 2 and 4 ranks is the
  one-rank step without a group: the loss, the grad norm, the parameters
  and the EMA after two SGD steps of the diffusion loss with the gradients
  clipped (each rank draws the global batch's t and noise and keeps its
  rows), to 1e-6; and with a deterministic loss the same step is the JAX
  ``make_train_step`` on the 8-device mesh (rtol 2e-4, atol 2e-6, the JAX
  test's bounds).
- Micro-batch accumulation: two micro-batches over 2 ranks are the
  one-rank two-micro-batch step (1e-6) and, with a deterministic loss, the
  full-batch step (the JAX test's 1e-5 / 1e-7).
- fsdp=2 (a 2 x 2 mesh; FSDP2 shards the parameters) is pure data
  parallelism over 4 ranks (1e-6), with parameters actually sharded and the
  gradients clipped through their shards; and so is fsdp=2 over 2 ranks
  with adafactor (momentum, parameter scaling, factored moments).
- Label dropout: the class-conditional AdaGN UNet with ``p_uncond`` 0.5
  over 2 ranks is the one-rank step (1e-6).
- Sampling through ``DataParallelSampler`` (a stochastic DDPM and DDIM) is
  the one-rank sampling, with a batch of 5 padded over 2 and 4 ranks (1e-5:
  the convolutions of a smaller batch sum in another order); only rank 0 is
  main.
- A checkpoint saved under fsdp=2 loads into a one-card train state with the
  gathered parameters, EMA and Adam moments of the sharded run, exactly.
- ``shard_dim`` is the JAX ``param_sharding`` rule, leaf by leaf, over a
  model's parameter shapes at fsdp 2, 4 and 8.
- A ``RowGenerator``'s per-row draws are the rows of the whole batch's draw
  (padded rows repeat their originals), it leaves the generator where the
  whole batch's draw does, and a draw of another row count raises.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dmtpu.models import UNet as JaxUNet
from dmtpu.parallel import TrainState as JaxTrainState
from dmtpu.parallel import make_mesh as jax_make_mesh
from dmtpu.parallel import make_train_step as jax_make_train_step
from dmtpu.parallel import param_sharding as jax_param_sharding
from dmtpu.parallel import shard_batch as jax_shard_batch
from dmtpu.parallel import shard_train_state as jax_shard_train_state
from dmtpu_torch.convert import load_flax_params
from dmtpu_torch.models.unet import UNet
from dmtpu_torch.models.unet_categorial_adagn import UNetCategorialAdaGN
from dmtpu_torch.parallel import TrainState
from dmtpu_torch.parallel.mesh import shard_dim
from dmtpu_torch.utils import checkpoint as ckpt_lib
from dmtpu_torch.utils import optim, rows
from tests import _torch_parallel_workers as W
from tests._torch_dist import spawn
from tests._torch_helpers import jax_random_params, nhwc


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """The tiny UNet's weights: seeded JAX params through the bridge; (file,
    the JAX params, the AdaGN UNet's file)."""
    d = tmp_path_factory.mktemp("weights")
    params = jax_random_params(JaxUNet(**W.UNET), jnp.zeros((1, 8, 8, 3)),
                               jnp.zeros((1,), jnp.int32))
    model = load_flax_params(UNet(**W.UNET), params)
    path = str(d / "unet.pt")
    torch.save(model.state_dict(), path)
    torch.manual_seed(0)
    adagn = str(d / "adagn.pt")
    torch.save(UNetCategorialAdaGN(**W.ADAGN).state_dict(), adagn)
    return path, params, adagn


def _close(got, want, atol=1e-6, rtol=0.0):
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=rtol, atol=atol,
                                   err_msg=k)


@pytest.mark.parametrize("world", [1, 2, 4])
def test_data_parallel_matches_one_rank(weights, tmp_path, world):
    path = weights[0]
    ranks = spawn(W.train, world, tmp_path, path, 1, 1, "diffusion", "sgd", 2, True, "unet",
                  None, None, 0.5)
    losses, norms, state, sharded = W.train(0, 0, path, n_steps=2, clip=0.5)
    assert min(norms) > 0.5  # the clipping acts
    for got in ranks:  # every rank ends with the same replicated state
        np.testing.assert_allclose(got[0], losses, rtol=1e-6)
        np.testing.assert_allclose(got[1], norms, rtol=1e-6)
        _close(got[2]["params"], state["params"])
        _close(got[2]["ema"], state["ema"])
    assert not ranks[0][3] and not sharded


def _jax_sgd_step(params, batch, micro_batches=1):
    """One SGD(0.1) step of mean(out^2) at t = 0 on the 8-device CPU mesh."""
    jmodel = JaxUNet(**W.UNET)

    def det_loss(p, b, rng):
        return jnp.mean(jmodel.apply(p, b, jnp.zeros((b.shape[0],), jnp.int32)) ** 2)

    tx = optax.sgd(0.1)
    mesh = jax_make_mesh(jax.devices("cpu"))
    state = jax_shard_train_state(JaxTrainState.create(params, tx, ema_decay=None), mesh)
    step = jax_make_train_step(det_loss, tx, micro_batches=micro_batches, mesh=mesh)
    state, metrics = step(state, jax_shard_batch(jnp.asarray(nhwc(batch.numpy())), mesh),
                          jax.random.PRNGKey(3))
    model = load_flax_params(UNet(**W.UNET), jax.device_get(state.params))
    return {k: p.detach() for k, p in model.named_parameters()}, float(metrics["loss"])


def test_data_parallel_matches_jax_mesh(weights, tmp_path):
    path, params = weights[:2]
    ranks = spawn(W.train, 2, tmp_path, path, 1, 1, "det", "sgd", 1, False)
    want, want_loss = _jax_sgd_step(params, W.batches(1)[0])
    got = ranks[0][2]["params"]
    np.testing.assert_allclose(ranks[0][0][0], want_loss, rtol=1e-5)
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=2e-4, atol=2e-6,
                                   err_msg=k)


def test_micro_batch_accumulation(weights, tmp_path):
    path = weights[0]
    ranks = spawn(W.train, 2, tmp_path, path, 1, 2, "diffusion", "sgd", 2)
    losses, _, state, _ = W.train(0, 0, path, micro_batches=2, n_steps=2)
    np.testing.assert_allclose(ranks[0][0], losses, rtol=1e-6)
    _close(ranks[0][2]["params"], state["params"])
    # a deterministic loss: two micro-batches over two ranks are the full batch
    det = spawn(W.train, 2, tmp_path, path, 1, 2, "det", "sgd", 1, False)
    full = W.train(0, 0, path, loss="det", ema=False)
    np.testing.assert_allclose(det[0][0], full[0], rtol=1e-6)
    _close(det[0][2]["params"], full[2]["params"], atol=1e-7, rtol=1e-5)


@pytest.mark.parametrize("opt,world", [pytest.param("sgd", 4, id="sgd"),
                                       pytest.param("adafactor", 2, id="adafactor")])
def test_fsdp_matches_pure_data_parallel(weights, tmp_path, opt, world):
    """With the gradients clipped at 0.5 (below their norm): the sharded norm
    and the scaling of the shards; SGD on a 2 x 2 mesh.  Adafactor
    (``W.ADAFACTOR``) on fsdp=2 alone: its factored moments, block RMS
    clipping and parameter scale are the whole parameter's under sharding,
    its bf16 momentum sharded as the parameter."""
    path = weights[0]
    fsdp = spawn(W.train, world, tmp_path, path, 2, 1, "diffusion", opt, 2, True, "unet", None,
                 None, 0.5)
    dp = W.train(0, 0, path, opt=opt, n_steps=2, clip=0.5)  # pure DP: the one-rank run (above)
    assert min(dp[1]) > 0.5
    assert fsdp[0][3], "fsdp=2 shards the parameters"
    np.testing.assert_allclose(fsdp[0][0], dp[0], rtol=1e-6)
    _close(fsdp[0][2]["params"], dp[2]["params"])
    _close(fsdp[0][2]["ema"], dp[2]["ema"])


def test_label_dropout(weights, tmp_path):
    adagn = weights[2]
    ranks = spawn(W.train, 2, tmp_path, adagn, 1, 1, "diffusion", "sgd", 1, True, "adagn", 0.5)
    losses, _, state, _ = W.train(0, 0, adagn, kind="adagn", p_uncond=0.5)
    np.testing.assert_allclose(ranks[0][0], losses, rtol=1e-6)
    assert np.isfinite(losses).all()
    _close(ranks[0][2]["params"], state["params"])


@pytest.mark.parametrize("world,sampler", [(2, "ddpm"), (4, "ddim")])
def test_dp_sampling_matches_one_rank(weights, tmp_path, world, sampler):
    path = weights[0]
    want, main = W.sample(0, 0, path, 5, sampler)
    ranks = spawn(W.sample, world, tmp_path, path, 5, sampler)
    assert main and [r[1] for r in ranks] == [True] + [False] * (world - 1)
    for got, _ in ranks:
        assert got.shape == (5, 3, 8, 8)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)


def test_fsdp_checkpoint_loads_on_one_card(weights, tmp_path):
    path = weights[0]
    ckpt = tmp_path / "ckpt"
    ranks = spawn(W.train, 2, tmp_path, path, 2, 1, "diffusion", "adam", 1, True, "unet", None,
                  str(ckpt))
    _, _, sharded_state, sharded = ranks[0]
    assert sharded
    model = W.build(path)
    state = TrainState.create(model, optim.adam(model.parameters(), lr=1e-3), ema_decay=0.999)
    ckpt_lib.load_checkpoint(str(ckpt / "step000001"), state)
    assert state.step == 1 and state.ema.num_updates == 1
    _close({k: p.detach() for k, p in model.named_parameters()}, sharded_state["params"],
           atol=0)
    _close(state.ema.shadow, sharded_state["ema"], atol=0)
    blob = ckpt_lib.load_checkpoint_host(str(ckpt / "step000001"))
    names = [n for n, _ in model.named_parameters()]
    for i, entry in blob["optimizer"]["state"].items():
        assert entry["exp_avg"].shape == model.get_parameter(names[i]).shape
    assert len(state.optimizer.state) == len(names)


def test_param_sharding_rule_matches_jax():
    shapes = {k: tuple(v.shape) for k, v in UNet(**W.UNET, device="meta").state_dict().items()}
    shapes.update(scalar=(), odd=(3, 5), tie=(8, 8, 3))
    tree = {k: jnp.zeros(s) for k, s in shapes.items()}
    for fsdp in (2, 4, 8):
        mesh = jax_make_mesh(jax.devices("cpu"), fsdp=fsdp)
        specs = jax_param_sharding(mesh, tree)
        for name, shape in shapes.items():
            spec = tuple(specs[name].spec)
            want = spec.index("fsdp") if "fsdp" in spec else None
            assert shard_dim(shape, fsdp) == want, (name, shape, fsdp)
    assert shard_dim((8, 8, 3), 2) == 0 and shard_dim((3, 5), 2) is None


@pytest.mark.parametrize("draw", ["randn", "rand", "randint"])
def test_row_generator_draws_the_whole_batch_s_rows(draw):
    def make(generator, shape):
        if draw == "randint":
            return rows.randint(0, 1000, shape, generator)
        return getattr(rows, draw)(shape, generator)

    held = torch.tensor([3, 4, 0])  # rank 1 of 2 over a batch of 5 padded to 6
    whole_gen, row_gen = torch.Generator().manual_seed(7), torch.Generator().manual_seed(7)
    whole = make(whole_gen, (5, 2, 3))
    got = make(rows.RowGenerator(row_gen, 5, held), (3, 2, 3))
    assert torch.equal(got, whole[held])
    assert torch.equal(make(whole_gen, (4,)), make(row_gen, (4,)))  # the same state after
    with pytest.raises(ValueError, match="per-row draw of shape"):
        make(rows.RowGenerator(row_gen, 5, held), (6, 2, 3))
