"""The program's spans and counters (``dmtpu_torch/utils/profiling.py``).

- Off (no profiler session): nothing is recorded, no ``record_function`` is
  entered and no CUDA event made; ``span`` hands back one shared no-op.
- On: ids, parents, roots, threads and counts of nested spans; a span opened
  on another thread inside a backward pass takes the waiting thread's span
  as parent; the buffer keeps the newest spans.
- The clock: a span's host times hold the profiler's own event of the work
  inside it.
- The span trees of a tiny text-to-image request (``sample_images``), a tiny
  class request (``sample_class``) and a tiny SD fine-tuning step
  (``make_train_step`` over ``make_sd_loss_fn``), on the configs of the CLI
  tests.
- ``weight_cast_bytes``: a bf16-torso UNet call counts 2 bytes for each
  element of the f32 parameters its casting layers copy; an f32 torso, none.
- On the card (``gpu``): a device span holds its kernel's launch in a
  CUDA-only profile, and the GroupNorm backward's span, opened on autograd's
  device thread, falls under the train step.
"""
import threading
from collections import deque

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dmtpu_torch.diffusions import DDIMCFG, DDPM
from dmtpu_torch.models import adm
from dmtpu_torch.parallel import TrainState, make_train_step
from dmtpu_torch.scripts import sample_cfg, sample_sd, train_sd
from dmtpu_torch.utils import optim, profiling
from dmtpu_torch.utils.config import instantiate_from_config, load_config

# The CLI tests' tiny configs are imported inside the tests that use them:
# their modules import JAX, which the card's machine, where the gpu-marked
# test runs, does not have.


@pytest.fixture(autouse=True)
def _empty():
    profiling.clear()
    yield
    profiling.clear()


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _children(spans, parent):
    return [s for s in spans if s.parent == parent.id]


def test_off_records_nothing_and_enters_no_range(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("entered while no profiler runs")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    assert not profiling.recording()
    assert profiling.span("a") is profiling.span("b", device=True)

    @profiling.spanned("c", device=True)
    def f(x):
        profiling.count("n", 3)
        return x + 1

    with profiling.span("a"):
        with profiling.span("b", device=True):
            profiling.count("n", 5)
            assert f(1) == 2
    assert profiling.recorded() == []


def test_nesting_ids_threads_and_counts():
    with _cpu_profile():
        assert profiling.recording()
        with profiling.span("root") as root:
            profiling.count("n", 2)
            with profiling.span("child") as child:
                profiling.count("n", 3)
                profiling.count("n", 4)
                with profiling.span("grandchild") as grand:
                    profiling.count("m", 1)
            other = {}

            def elsewhere():  # another thread, outside a backward: a root of its own
                with profiling.span("other") as s:
                    other["span"] = s

            t = threading.Thread(target=elsewhere)
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
        with profiling.span("second"):
            pass
    assert not profiling.recording()
    spans = profiling.recorded()
    assert [s.name for s in spans] == ["root", "child", "grandchild", "other", "second"]
    assert (root.parent, root.root) == (None, root.id)
    assert (child.parent, child.root) == (root.id, root.id)
    assert (grand.parent, grand.root) == (child.id, root.id)
    assert root.counts == {"n": 2} and child.counts == {"n": 7} and grand.counts == {"m": 1}
    o = other["span"]
    assert o.parent is None and o.root == o.id and o.thread != root.thread
    assert spans[-1].parent is None and spans[-1].root == spans[-1].id
    assert len({s.id for s in spans}) == 5
    for s in spans:
        assert s.start_ns <= s.end_ns and s.device_ms is None
    assert root.start_ns <= child.start_ns <= grand.start_ns <= grand.end_ns <= child.end_ns


class _Spanned(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return 2 * x

    @staticmethod
    def backward(ctx, grad):
        with profiling.span("inner.backward"):
            return 2 * grad


def test_a_span_opened_in_a_backward_on_another_thread_joins_the_waiting_span():
    """As autograd's device thread runs a CUDA backward: the thread that
    opens the span has none open, the caller of ``.backward()`` waits in
    its span."""
    x = torch.ones(3, requires_grad=True)
    with _cpu_profile():
        with profiling.span("train.step") as step:
            loss = _Spanned.apply(x).sum()
            with profiling.span("train.backward") as waiting:
                t = threading.Thread(target=loss.backward)
                t.start()
                t.join(timeout=30)
                assert not t.is_alive()
    inner = [s for s in profiling.recorded() if s.name == "inner.backward"]
    assert len(inner) == 1 and inner[0].thread != waiting.thread
    assert inner[0].parent == waiting.id and inner[0].root == step.id
    assert torch.equal(x.grad, torch.full((3,), 2.0))


def test_the_buffer_keeps_the_newest_spans(monkeypatch):
    assert profiling._spans.maxlen == profiling.SPAN_BUFFER
    monkeypatch.setattr(profiling, "_spans", deque(maxlen=4))
    with _cpu_profile():
        for i in range(7):
            with profiling.span(f"s{i}"):
                pass
    assert [s.name for s in profiling.recorded()] == ["s3", "s4", "s5", "s6"]
    profiling.clear()
    assert profiling.recorded() == []


def test_span_holds_the_profiler_event_of_its_work():
    a = torch.randn(64, 64)
    with _cpu_profile() as prof:
        with profiling.span("matmul") as s:
            torch.mm(a, a)
    mm = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    assert len(mm) == 1
    start = mm[0].start_ns()
    assert s.start_ns <= start <= start + mm[0].duration_ns() <= s.end_ns
    assert "matmul" in {e.name for e in prof.events()}


def test_sample_images_span_tree(tmp_path):
    from tests._tiny_fixtures import tiny_sd_config

    conf = load_config(tiny_sd_config(tmp_path / "sd.yaml"))
    with _cpu_profile():
        sample_sd.sample_images(conf, "a tiny cat", n_samples=2, batch_size=2, height=32,
                                width=32, respace_steps=3, guidance_scale=3.0, device="cpu")
    spans = profiling.recorded()
    roots = [s for s in spans if s.parent is None]
    assert [r.name for r in roots] == ["request"]
    request = roots[0]
    assert [s.name for s in _children(spans, request)] == ["text_encode", "sample", "decode",
                                                            "to_host"]
    sample = _children(spans, request)[1]
    denoisers = _children(spans, sample)
    assert len(denoisers) >= 2 and {s.name for s in denoisers} == {"denoiser"}
    assert all(s.root == request.id for s in spans)
    assert len(spans) == 5 + len(denoisers)


def test_sample_class_span_tree():
    from tests.test_torch_sample_cfg_cli import VAE, VIT

    model = instantiate_from_config({"target": "models.dit.dit.DiT",
                                     "params": {"vit_config": VIT, "vae_config": VAE}}).eval()
    diffuser = DDIMCFG(total_steps=50, respace_type="uniform", respace_steps=3,
                       guidance_scale=2.0)
    with _cpu_profile():
        sample_cfg.sample_class(model, diffuser, 1, 2, shape=(4, 4, 4), num_classes=5,
                                batch_size=2, device="cpu")
    spans = profiling.recorded()
    request = spans[0]
    assert request.name == "request" and request.parent is None
    assert [s.name for s in _children(spans, request)] == ["sample", "decode"]
    sample = _children(spans, request)[0]
    assert len(_children(spans, sample)) == len(diffuser.respaced_seq)
    assert {s.name for s in _children(spans, sample)} == {"denoiser"}
    assert all(s.root == request.id for s in spans)


def _tiny_sd_model():
    from tests._tiny_fixtures import _tiny_sd_model

    return _tiny_sd_model()


def _tiny_sd_step():
    sd = instantiate_from_config(_tiny_sd_model())
    for frozen in (sd.vae, sd.text_encoder):
        frozen.requires_grad_(False).eval()
    state = TrainState.create(sd.unet, optim.adafactor(sd.unet.parameters(), lr=1e-4),
                              ema_decay=0.99)
    empty = torch.zeros(1, 16, dtype=torch.long)
    loss_fn = train_sd.make_sd_loss_fn(sd, DDPM(total_steps=100), empty, 0.25, 100)
    gen = torch.Generator().manual_seed(0)
    batch = {"image": torch.rand(2, 3, 32, 32, generator=gen) * 2 - 1,
             "input_ids": torch.randint(3, 255, (2, 16), generator=gen)}
    return state, make_train_step(loss_fn, clip_grad_norm=1.0), batch


def test_train_step_span_tree():
    state, step_fn, batch = _tiny_sd_step()
    with _cpu_profile():
        step_fn(state, batch)
    spans = profiling.recorded()
    step = spans[0]
    assert step.name == "train.step" and step.parent is None
    top = _children(spans, step)
    assert [s.name for s in top] == ["train.forward", "train.backward", "train.clip",
                                     "train.optimizer", "train.ema"]
    assert [s.name for s in _children(spans, top[0])] == ["vae.encode", "text_encode",
                                                          "denoiser"]
    assert all(s.root == step.id for s in spans)
    # each GroupNorm's autograd node opens its span inside the backward
    norms = sum(isinstance(m, adm.GroupNorm32) for m in state.model.modules())
    assert norms > 0 and [s.name for s in _children(spans, top[1])] == \
        ["GroupNormSiLU.backward"] * norms
    assert len(spans) == 9 + norms
    assert state.step == 1


def _cast_bytes_expected(unet):
    """2 bytes for each element of the f32 parameters of the layers that
    compute in bf16 (``adm.Linear`` / ``Conv2d`` / ``Conv1d``), worked out
    from the module list."""
    total = 0
    for m in unet.modules():
        if isinstance(m, (adm.Linear, adm.Conv2d, adm.Conv1d)) \
                and m.compute_dtype == torch.bfloat16:
            total += sum(p.numel() for p in m.parameters(recurse=False)
                         if p.dtype != torch.bfloat16)
    return 2 * total


@pytest.mark.parametrize("torso", ["bfloat16", None])
def test_weight_cast_bytes_of_a_unet_call(torso):
    conf = _tiny_sd_model()["params"]["unet_config"]
    conf["params"]["torso_dtype"] = torso
    unet = instantiate_from_config(conf).eval()
    x, t, ctx = torch.randn(2, 4, 8, 8), torch.tensor([3, 7]), torch.randn(2, 16, 32)
    with torch.no_grad(), _cpu_profile():
        with profiling.span("denoiser") as call:
            unet(x, t, ctx)
    got = (call.counts or {}).get("weight_cast_bytes", 0)
    want = _cast_bytes_expected(unet)
    if torso is None:
        assert got == want == 0
    else:
        assert got == want > 0
        # outside a profiler session nothing is counted
        with torch.no_grad(), profiling.span("denoiser"):
            unet(x, t, ctx)
        assert len(profiling.recorded()) == 1


@pytest.mark.gpu
def test_device_span_holds_its_launch_and_the_gn_backward_joins_the_step():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from dmtpu_torch.ops.groupnorm import group_norm

    dev = torch.device("cuda")
    a = torch.randn(256, 256, device=dev)
    torch.add(a, 1.0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with profiling.span("add", device=True) as s:
            torch.add(a, 1.0)
        torch.cuda.synchronize()
    # cudaLaunchKernel, or cudaLaunchKernelExC where a library launches
    launches = [e for e in prof.profiler.kineto_results.events()
                if "LaunchKernel" in e.name()]
    assert launches, sorted({e.name() for e in prof.profiler.kineto_results.events()})
    assert any(s.start_ns <= e.start_ns() <= e.start_ns() + e.duration_ns() <= s.end_ns
               for e in launches)
    assert s.device_ms is not None and s.device_ms > 0

    x = torch.randn(2, 64, 8, 8, device=dev, requires_grad=True)
    w = torch.ones(64, device=dev, requires_grad=True)
    b = torch.zeros(64, device=dev, requires_grad=True)
    profiling.clear()
    with profile(activities=[ProfilerActivity.CUDA]):
        with profiling.span("train.step", device=True) as step:
            loss = group_norm(x, w, b, 32, 1e-5, True).square().sum()
            with profiling.span("train.backward") as waiting:
                loss.backward()
        torch.cuda.synchronize()
    gn = [s for s in profiling.recorded() if s.name == "GroupNormSiLU.backward"]
    assert len(gn) == 1 and gn[0].root == step.id and gn[0].parent == waiting.id
    assert gn[0].thread != waiting.thread  # autograd's device thread
    assert step.device_ms > 0
    assert np.isfinite(x.grad.float().cpu().numpy()).all()
