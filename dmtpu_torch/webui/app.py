"""The web UI: a stdlib HTTP server that samples a pixel-space model.

    python -m dmtpu_torch.webui.app -c configs/ddpm_cifar10.yaml --weights W \\
        [--port 7860] [--device cuda|cpu]

Counterpart of the JAX package's ``webui/app.py``, with the same routes and
query keys:

- ``/``: the form (sampler, steps, variance, batch, seed, class and
  guidance scale);
- ``/sample?sampler=&steps=&var_type=&n=&seed=&y=&gs=``: the page with the
  samples' grid as an embedded PNG; an error comes back as the page with
  ``<pre>error: ...</pre>``;
- ``/health``: JSON naming the torch device and, on a card, its name;
- anything else: 404.

The model is loaded once; requests run one at a time (a lock).  The sampler
family gate and its refusal are ``ui/uncond.py``'s: a flow config offers
``flow`` / ``flowdpm``, any other the eps samplers, DDIM preselected.  A
class-conditional model samples class ``y`` with guidance scale ``gs``
(``ui/cfg.py``) and, for ``y`` < 0, the null-class row.  The JAX server's
bounded cache of compiled samplers has no counterpart: the port compiles
nothing.  On the card the attention kernel takes bf16: give an f32 pixel
config a bf16 torso (``dtype: bfloat16`` in its model params).  Everything
runs on the card unless ``--device cpu`` is given; without a card the
server does not start.
"""
from __future__ import annotations

import argparse
import base64
import io
import json
import math
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer
from typing import Any, Optional, Sequence
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from dmtpu_torch.scripts._common import image_shape
from dmtpu_torch.scripts.sample_sd import resolve_device
from dmtpu_torch.ui import cfg, uncond
from dmtpu_torch.utils.image import make_grid, to_pil

PAGE = """<!doctype html>
<html><head><title>dmtpu sampler</title><style>
body{{font-family:sans-serif;max-width:760px;margin:2em auto}}
label{{display:inline-block;width:160px}} input,select{{margin:4px}}
img{{image-rendering:pixelated;border:1px solid #ccc;margin-top:1em}}
</style></head><body>
<h2>dmtpu — diffusion sampler</h2>
<form action="/sample" method="get">
<p><label>Sampler</label><select name="sampler">
{sampler_options}
</select></p>
<p><label>Steps</label><input name="steps" type="number" value="50"></p>
<p><label>Variance</label><select name="var_type">
<option>fixed_large</option><option>fixed_small</option><option>learned_range</option></select></p>
<p><label>Batch</label><input name="n" type="number" value="16" min="1" max="64"></p>
<p><label>Seed</label><input name="seed" type="number" value="0"></p>
<p><label>Class (CFG, opt.)</label><input name="y" type="number" placeholder="-1 = uncond" value="-1">
   <label>guidance scale</label><input name="gs" type="number" step="0.5" value="3"></p>
<p><input type="submit" value="Sample"></p>
</form>
{body}
</body></html>"""


class App:
    """The loaded model and its sampling, shared by the handler's requests."""

    def __init__(self, conf_path: str, weights: str, device: Any = None):
        self.device = resolve_device("cuda" if device is None else str(device), cli="webui")
        self.conf, self.model = uncond.load_pixel_model(conf_path, weights, self.device)
        self.num_classes = self.conf["data"].get("num_classes")
        self.shape = image_shape(self.conf)
        self.cond = uncond.is_conditional(self.conf)
        self.is_flow = uncond.is_flow(self.conf)
        self.samplers = uncond.sampler_names(self.conf)
        self.default_sampler = uncond.default_sampler(self.conf)
        self.lock = threading.Lock()

    def page(self, body: str) -> str:
        opts = "".join(
            f'<option{" selected" if s == self.default_sampler else ""}>{s}</option>'
            for s in self.samplers)
        return PAGE.format(sampler_options=opts, body=body)

    def sample(self, sampler: str, steps: int, var_type: str, n: int, seed: int, y: int,
               gs: float, noise: Any = None) -> np.ndarray:
        """``n`` samples, [n, H, W, C] in [-1, 1] on the host; ``noise`` ([n,
        C, H, W]) replaces the noise drawn from ``seed``."""
        kw = dict(sampler=sampler, steps=steps, var_type=var_type, respace_type="uniform", n=n,
                  seed=seed, device=self.device, noise=noise)
        if y >= 0 and self.cond:
            images = cfg.generate_cfg(self.conf, self.model, y, scale=gs, **kw)
        else:
            images = uncond.generate_uncond(self.conf, self.model, **kw)
        return images.permute(0, 2, 3, 1).cpu().numpy()


def png_grid(images: np.ndarray) -> bytes:
    """[N, H, W, C] in [-1, 1] as one PNG grid of ceil(sqrt(N)) columns."""
    buf = io.BytesIO()
    to_pil(make_grid(images, nrow=int(math.ceil(math.sqrt(len(images)))))).save(buf, "PNG")
    return buf.getvalue()


def make_handler(app: App):
    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            url = urlparse(self.path)
            if url.path == "/":
                self._html(app.page(""))
            elif url.path == "/sample":
                q = {k: v[0] for k, v in parse_qs(url.query).items()}
                try:
                    with app.lock:
                        imgs = app.sample(
                            q.get("sampler", app.default_sampler), int(q.get("steps", 50)),
                            q.get("var_type", "fixed_small"), int(q.get("n", 16)),
                            int(q.get("seed", 0)), int(q.get("y", -1)),
                            float(q.get("gs", 3.0)))
                    b64 = base64.b64encode(png_grid(imgs)).decode()
                    self._html(app.page(
                        f'<img src="data:image/png;base64,{b64}" width="512">'))
                except Exception as e:
                    self._html(app.page(f"<pre>error: {e}</pre>"))
            elif url.path == "/health":
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.end_headers()
                name = (torch.cuda.get_device_name(app.device) if app.device.type == "cuda"
                        else None)
                self.wfile.write(json.dumps({"ok": True, "device": str(app.device),
                                             "device_name": name}).encode())
            else:
                self.send_response(404)
                self.end_headers()

        def _html(self, content: str):
            self.send_response(200)
            self.send_header("Content-Type", "text/html")
            self.end_headers()
            self.wfile.write(content.encode())

        def log_message(self, *a):  # quiet
            pass

    return Handler


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-c", "--config", required=True)
    p.add_argument("--weights", required=True)
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    args = p.parse_args(argv)
    app = App(args.config, args.weights, args.device)
    server = HTTPServer(("0.0.0.0", args.port), make_handler(app))
    print(f"webui listening on http://localhost:{args.port} ({app.device})")
    server.serve_forever()


if __name__ == "__main__":
    main()
