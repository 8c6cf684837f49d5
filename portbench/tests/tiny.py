"""Tiny copies of the cells' configurations and workloads, for runs on the
CPU: every width cut down, every kind of layer kept."""
from __future__ import annotations

import copy
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _load(kind: str, name: str) -> dict:
    return json.loads((ROOT / kind / f"{name}.json").read_text())


def _tiny_vae(vae: dict) -> None:
    vae["params"].update(ch=32, ch_mult=[1, 2], num_res_blocks=1)


def config(name: str) -> dict:
    conf = copy.deepcopy(_load("configs", name))
    p = conf["model"]["params"]
    _tiny_vae(p["vae_config"])
    if "unet_config" in p:
        p["unet_config"]["params"].update(model_channels=32, channel_mult=[1, 2],
                                          attention_resolutions=[2], num_heads=2,
                                          num_res_blocks=1, context_dim=32)
        p["text_encoder_config"]["params"]["config_overrides"] = dict(
            width=32, layers=2, heads=2, vocab_size=1000)
        p["text_encoder_config"]["params"]["max_length"] = 8
    if "vit_config" in p:
        p["vit_config"]["params"].update(input_size=8, hidden_size=64, depth=2, num_heads=2,
                                         num_classes=10)
    return conf


def workload(name: str) -> dict:
    work = copy.deepcopy(_load("workloads", name))
    p = work["params"]
    if work["traffic"] in ("txt2img", "class_sample"):
        p.update(batch=2, steps=3)
        if "height" in p:
            p.update(height=32, width=32)
        work["check"]["images"] = 2
    else:
        p.update(batch=4, pool=3, chunks=2)
        if "size" in p:
            p.update(size=32)
    work["trace_units"] = work["trace_host_units"] = 1
    return work
