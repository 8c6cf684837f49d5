"""dmtpu_torch's web UI (``dmtpu_torch/webui/app.py``) against the JAX
package's ``webui/app.py``, on ``tests/_tiny_fixtures.py``'s configs (the
UNet and the AdaGN UNet at 8x8) in f32 on the CPU.

- Parity: each ``App.sample`` branch (unconditional, CFG, and
  unconditional on the conditional model: its null-class row) from the same
  ``.npz`` weights and the JAX server's own noise (its
  ``split(PRNGKey(seed))``) handed to the port, DDIM, so that the sampler's
  key plays no part: the samples within 1e-5 relative L2 (f32 sums in
  other orders over 4 steps of a tiny UNet, 3.5e-7 seen; another class, or
  class 0 for the null row, is more than 100 times that).
- The HTTP surface of ``python -m dmtpu_torch.webui.app`` with ``--device
  cpu`` on a free loopback port: ``/``, ``/sample`` (a PNG grid of the
  request's size), ``/health``, 404, the flow config's sampler gate and its
  refusal message; and no quiet CPU path: the default device needs a card.
"""
import base64
import io
import re
import socket
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from dmtpu_torch.webui import app as tapp
from tests._tiny_fixtures import save_npz_params, tiny_cfg_config, tiny_uncond_config, write_yaml
from tests.test_webui import _load_app_module

PARITY = 1e-5
STEPS, N, SEED = 4, 2, 1


def _uncond_weights(tmp_path):
    from dmtpu.models import UNet

    conf = tiny_uncond_config(tmp_path / "conf.yaml")
    model = UNet(in_channels=3, out_channels=3, dim=32, dim_mults=(1, 2),
                 use_attn=(False, True), num_res_blocks=1, n_heads=1)
    return conf, save_npz_params(tmp_path / "w.npz", model,
                                 (jnp.zeros((1, 8, 8, 3)), jnp.zeros((1,), jnp.int32)))


def _cfg_weights(tmp_path):
    from dmtpu.models import UNetCategorialAdaGN

    conf = tiny_cfg_config(tmp_path / "conf.yaml")
    model = UNetCategorialAdaGN(in_channels=3, out_channels=3, dim=32, dim_mults=(1, 2),
                                use_attn=(False, True), num_res_blocks=1, num_classes=10)
    return conf, save_npz_params(tmp_path / "w.npz", model,
                                 (jnp.zeros((1, 8, 8, 3)), jnp.zeros((1,), jnp.int32),
                                  jnp.zeros((1,), jnp.int32)))


def _jax_noise(seed, n, shape=(8, 8, 3)):
    """The JAX server's noise of a request (``webui/app.py:155-156``), NCHW."""
    k_noise, _ = jax.random.split(jax.random.PRNGKey(seed))
    noise = np.asarray(jax.random.normal(k_noise, (n,) + shape))
    return np.ascontiguousarray(noise.transpose(0, 3, 1, 2))


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.fixture(scope="module")
def jax_app_mod():
    return _load_app_module()


@pytest.mark.parametrize("branch", ["uncond", "cfg", "null_row"])
def test_app_sample_matches_jax(jax_app_mod, tmp_path, branch):
    """One request of each branch: DDIM-4, b2, seed 1; CFG class 3 at scale 2."""
    conf, weights = (_uncond_weights if branch == "uncond" else _cfg_weights)(tmp_path)
    y, gs = (3, 2.0) if branch == "cfg" else (-1, 3.0)
    want = jax_app_mod.App(conf, weights).sample("ddim", STEPS, "fixed_small", N, SEED, y, gs)
    app = tapp.App(conf, weights, device="cpu")
    assert app.cond == (branch != "uncond")
    got = app.sample("ddim", STEPS, "fixed_small", N, SEED, y, gs, noise=_jax_noise(SEED, N))
    assert got.shape == want.shape == (N, 8, 8, 3) and np.abs(want).max() > 0.1
    assert _rel_l2(got, want) <= PARITY, _rel_l2(got, want)
    if branch != "uncond":
        # another class; or, for the null row, class 0 (guidance scale 1 is
        # the conditional model alone): far off
        other = app.sample("ddim", STEPS, "fixed_small", N, SEED, 0,
                           gs if branch == "cfg" else 1.0, noise=_jax_noise(SEED, N))
        assert _rel_l2(other, want) > 100 * PARITY, _rel_l2(other, want)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _serve(app):
    from http.server import HTTPServer

    server = HTTPServer(("127.0.0.1", _free_port()), tapp.make_handler(app))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, server.server_address[1]


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=120) as r:
        return r.status, r.read().decode()


def _png_size(body):
    from PIL import Image

    m = re.search(r"data:image/png;base64,([A-Za-z0-9+/=]+)", body)
    assert m, body[:500]
    return Image.open(io.BytesIO(base64.b64decode(m.group(1)))).size


def test_http_surface_on_the_cpu(tmp_path):
    conf, weights = _uncond_weights(tmp_path)
    server, port = _serve(tapp.App(conf, weights, device="cpu"))
    try:
        status, body = _get(port, "/health")
        assert status == 200 and '"ok": true' in body and '"device": "cpu"' in body
        status, body = _get(port, "/")
        assert status == 200 and "<option selected>ddim</option>" in body
        assert ">flow</option>" not in body
        # 4 samples of 8x8 in a 2x2 grid with 2-pixel padding
        status, body = _get(port, "/sample?sampler=ddim&steps=4&n=4&seed=1")
        assert status == 200 and _png_size(body) == (2 + 2 * 10, 2 + 2 * 10)
        status, body = _get(port, "/sample?sampler=pfdiff&steps=4&n=2&seed=1")
        assert status == 200 and "data:image/png;base64," in body, body[:500]
        status, body = _get(port, "/sample?sampler=flow&steps=4&n=2&seed=1")
        assert "data:image/png;base64," not in body and "<pre>error: " in body
        assert "does not match" in body
        with pytest.raises(urllib.error.HTTPError) as exc:
            _get(port, "/nope")
        assert exc.value.code == 404
    finally:
        server.shutdown()


def test_http_flow_config_gates_samplers(tmp_path):
    """A flow config offers only flow / flowdpm, flow preselected and the
    default of a bare request; flowdpm overrides the config's euler solver;
    an eps sampler is refused with the JAX server's message."""
    base, weights = _uncond_weights(tmp_path)
    conf_d = yaml.safe_load(open(base))
    conf_d["diffusion"] = {"target": "diffusions.flow.FlowMatching",
                           "params": {"total_steps": 100, "solver": "euler"}}
    conf = write_yaml(tmp_path / "flow.yaml", conf_d)
    app = tapp.App(conf, weights, device="cpu")
    assert app.samplers == ("flow", "flowdpm") and app.is_flow
    server, port = _serve(app)
    try:
        status, body = _get(port, "/")
        assert "<option selected>flow</option>" in body and "<option>flowdpm</option>" in body
        assert ">ddim</option>" not in body
        status, body = _get(port, "/sample?steps=4&n=2&seed=1")
        assert status == 200 and "data:image/png;base64," in body, body[:500]
        status, body = _get(port, "/sample?sampler=ddpm&steps=4&n=2&seed=1")
        assert status == 200 and "does not match" in body and "available: flow, flowdpm" in body
        status, body = _get(port, "/sample?sampler=flowdpm&steps=4&n=2&seed=1")
        assert status == 200 and "data:image/png;base64," in body, body[:500]
    finally:
        server.shutdown()


def test_main_needs_a_card_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    """``main`` with the default device raises without a card; with
    ``--device cpu`` it builds the app and serves (``serve_forever`` stubbed)."""
    conf, weights = _uncond_weights(tmp_path)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tapp.main(["-c", conf, "--weights", weights, "--port", str(_free_port())])
    served = []
    monkeypatch.setattr(tapp.HTTPServer, "serve_forever", lambda self: served.append(self))
    port = _free_port()
    tapp.main(["-c", conf, "--weights", weights, "--port", str(port), "--device", "cpu"])
    assert len(served) == 1 and served[0].server_address[1] == port
    served[0].server_close()
