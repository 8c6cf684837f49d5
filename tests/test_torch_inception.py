"""dmtpu_torch.eval.inception against dmtpu.eval.inception on the CPU.

Each block (``BasicConv2d``, ``InceptionA``-``E``) is built from the JAX
module's variables (``{"params", "batch_stats"}``, seeded random values,
running statistics far from 0 / 1) through the Flax bridge's
``batch_stats`` rule and run on the same input at small spatial sizes:
within 1e-5 (f32 rounding order).  The whole graph runs at 2 x 299² from the
fabricated upstream ``.pth`` of ``tests/test_accept.py``, through both
packages' extractors: pool3 and probabilities within 1e-5 relative L2.  The
resize is ``jax.image.resize(..., "bilinear")``'s within 1e-5, which needs
``antialias=True`` where it shrinks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmtpu.eval import inception as jinc
from dmtpu_torch.convert import load_flax_params
from dmtpu_torch.diffusions.guidance.clip_guidance import _bilinear
from dmtpu_torch.eval import inception as tinc
from tests._torch_helpers import fake_inception_pth, nhwc, t

CPU = jax.devices("cpu")[0]


def _variables(module, x, seed):
    """Seeded random variables of the Flax ``module`` at input ``x``, from
    its shapes (no init run): kernels N(0, 1 / fan_in), scales 1 + N(0,
    0.1²), biases and means N(0, 0.1²), variances 0.5 + |N(0, 1)|."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), x)
    rs = np.random.RandomState(seed)

    def go(tree, name=""):
        if hasattr(tree, "items"):
            return {k: go(v, k) for k, v in tree.items()}
        noise = rs.randn(*tree.shape).astype(np.float32)
        if name == "kernel":
            return noise / np.sqrt(np.prod(tree.shape[:-1]))
        if name == "var":
            return 0.5 + np.abs(noise)
        return (1.0 if name == "scale" else 0.0) + 0.1 * noise

    return go(shapes)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


BLOCKS = {
    "conv3x3_s2": (lambda: jinc.BasicConv2d(32, (3, 3), strides=(2, 2)),
                   lambda c: tinc.BasicConv2d(c, 32, 3, stride=2), 9),
    "conv1x7": (lambda: jinc.BasicConv2d(48, (1, 7), padding=(0, 3)),
                lambda c: tinc.BasicConv2d(c, 48, (1, 7), padding=(0, 3)), 7),
    "conv5x5": (lambda: jinc.BasicConv2d(64, (5, 5), padding=2),
                lambda c: tinc.BasicConv2d(c, 64, 5, padding=2), 6),
    "A": (lambda: jinc.InceptionA(32), lambda c: tinc.InceptionA(c, 32), 7),
    "B": (lambda: jinc.InceptionB(), lambda c: tinc.InceptionB(c), 9),
    "C": (lambda: jinc.InceptionC(16), lambda c: tinc.InceptionC(c, 16), 7),
    "D": (lambda: jinc.InceptionD(), lambda c: tinc.InceptionD(c), 9),
    "E_avg": (lambda: jinc.InceptionE("avg"), lambda c: tinc.InceptionE(c, "avg"), 5),
    "E_max": (lambda: jinc.InceptionE("max"), lambda c: tinc.InceptionE(c, "max"), 5),
}


@pytest.mark.parametrize("name", list(BLOCKS))
def test_block_matches_flax_through_the_batch_stats_bridge(name):
    make_jax, make_torch, hw = BLOCKS[name]
    c = 16
    x = np.random.RandomState(1).randn(2, hw, hw, c).astype(np.float32)
    jmod = make_jax()
    with jax.default_device(CPU):
        variables = _variables(jmod, jnp.asarray(x), seed=2)
        want = np.asarray(jax.jit(jmod.apply)(variables, jnp.asarray(x)))
    tmod = load_flax_params(make_torch(c), variables).eval()
    sd = tmod.state_dict()
    # the running statistics came from batch_stats, not from the defaults
    key = next(k for k in sd if k.endswith("bn.running_var"))
    assert not torch.equal(sd[key], torch.ones_like(sd[key]))
    with torch.no_grad():
        got = nhwc(tmod(t(x).permute(0, 3, 1, 2)).numpy())
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_bridge_names_the_running_statistics():
    from dmtpu_torch.convert import state_dict_from_flax

    variables = {"params": {"Mixed_5b": {"branch1x1": {
                    "conv": {"kernel": np.zeros((1, 1, 4, 8), np.float32)},
                    "bn": {"scale": np.ones(8, np.float32), "bias": np.zeros(8, np.float32)}}}},
                 "batch_stats": {"Mixed_5b": {"branch1x1": {"bn": {
                     "mean": np.full(8, 2.0, np.float32), "var": np.full(8, 3.0, np.float32)}}}}}
    sd = state_dict_from_flax(variables)
    assert sorted(sd) == ["Mixed_5b.branch1x1.bn.bias", "Mixed_5b.branch1x1.bn.running_mean",
                          "Mixed_5b.branch1x1.bn.running_var", "Mixed_5b.branch1x1.bn.weight",
                          "Mixed_5b.branch1x1.conv.weight"]
    assert float(sd["Mixed_5b.branch1x1.bn.running_var"][0]) == 3.0
    variables["batch_stats"]["Mixed_5b"]["branch1x1"]["bn"]["count"] = np.zeros(8)
    with pytest.raises(ValueError, match="unknown batch_stats leaf 'count'"):
        state_dict_from_flax(variables)


@pytest.mark.parametrize("src,dst", [(32, 299), (256, 299), (512, 299), (256, 224), (299, 64)])
def test_resize_is_jax_bilinear(src, dst):
    x = np.random.RandomState(src).rand(1, src, src, 3).astype(np.float32)
    with jax.default_device(CPU):
        want = np.asarray(jax.image.resize(jnp.asarray(x), (1, dst, dst, 3), "bilinear"))
    got = nhwc(_bilinear(t(x).permute(0, 3, 1, 2), (dst, dst)).numpy())
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_resize_without_antialias_would_not_match_at_512():
    x = np.random.RandomState(512).rand(1, 512, 512, 3).astype(np.float32)
    with jax.default_device(CPU):
        want = np.asarray(jax.image.resize(jnp.asarray(x), (1, 299, 299, 3), "bilinear"))
    plain = torch.nn.functional.interpolate(t(x).permute(0, 3, 1, 2), size=(299, 299),
                                            mode="bilinear", align_corners=False)
    assert np.abs(nhwc(plain.numpy()) - want).max() > 0.1


def test_train_mode_changes_no_feature_and_no_buffer():
    torch.manual_seed(0)
    block = tinc.InceptionE(16, "max")
    with torch.no_grad():
        for name, buf in block.named_buffers():
            buf.copy_(torch.rand_like(buf) + (0.5 if name.endswith("var") else -0.5))
    x = torch.randn(2, 16, 5, 5)
    before = {k: v.clone() for k, v in block.state_dict().items()}
    with torch.no_grad():
        want = block.eval()(x)
        got = block.train()(x)
    assert torch.equal(got, want)
    assert all(torch.equal(before[k], v) for k, v in block.state_dict().items())
    assert not any(k.endswith("num_batches_tracked") for k in before)


def test_parameter_count_and_output_shapes():
    model = tinc.FIDInceptionV3()
    n = sum(p.numel() for p in model.parameters())
    assert 23_000_000 < n < 26_000_000
    with torch.no_grad():
        pool3, logits = model.eval()(torch.rand(1, 3, 32, 32))
    assert pool3.shape == (1, 2048) and logits.shape == (1, 1008)


@pytest.fixture(scope="module")
def inception_pth(tmp_path_factory):
    return fake_inception_pth(tmp_path_factory.mktemp("inception"))


def test_upstream_file_loads_and_unknown_keys_are_refused(inception_pth):
    from dmtpu.convert.common import load_torch_weights as jax_load
    from dmtpu_torch.scripts._common import load_torch_weights

    sd = load_torch_weights(inception_pth)
    sd["Conv2d_1a_3x3.bn.num_batches_tracked"] = torch.tensor(0)  # skipped
    converted = tinc.convert_inception_checkpoint(sd)
    assert set(converted) == set(tinc.FIDInceptionV3().state_dict())
    model = tinc.FIDInceptionV3()
    model.load_state_dict(converted)
    # the JAX converter reads the same file into the same values
    jvars = jinc.convert_inception_checkpoint(jax_load(inception_pth))
    from_bridge = load_flax_params(tinc.FIDInceptionV3(), jvars).state_dict()
    assert all(torch.equal(from_bridge[k], v) for k, v in model.state_dict().items())
    with pytest.raises(ValueError, match="unexpected inception key AuxLogits.fc.weight"):
        tinc.convert_inception_checkpoint({**sd, "AuxLogits.fc.weight": np.zeros((10, 768))})


def test_extractor_matches_jax_at_299_and_sweeps_once(inception_pth):
    images = np.random.RandomState(7).randint(0, 256, (2, 299, 299, 3)).astype(np.uint8)
    with jax.default_device(CPU):
        jpool3, jprobs = jinc.InceptionFeatureExtractor(inception_pth,
                                                        batch_size=2).features_and_probs(images)
    ext = tinc.InceptionFeatureExtractor(inception_pth, batch_size=1, device="cpu")
    calls = []
    ext.module.register_forward_hook(lambda *a: calls.append(1))
    pool3, probs = ext.features_and_probs(images)
    assert pool3.shape == (2, 2048) and probs.shape == (2, 1008)
    assert _rel(pool3, jpool3) < 1e-5 and _rel(probs, jprobs) < 1e-5
    assert np.array_equal(ext(images), pool3) and np.array_equal(ext.classify(images), probs)
    assert len(calls) == 2  # one forward a batch of 1, in one sweep


def test_exact_f32_puts_the_caller_s_flags_back():
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        with tinc.exact_f32():
            assert not torch.backends.cudnn.allow_tf32
            assert not torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def test_extractor_needs_a_card_unless_asked_for_the_cpu(inception_pth, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tinc.InceptionFeatureExtractor(inception_pth)
