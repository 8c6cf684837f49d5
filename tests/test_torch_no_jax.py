"""The port stands alone: no module of ``dmtpu_torch`` and not ``chip_smoke.py``
imports JAX, Flax or the JAX package (``dmtpu``), at any depth of the
module (inside functions too).  Read from the sources with ``ast``; the
names may appear in docstrings and comments, which are not imports."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "dmtpu"}
SOURCES = sorted(p.relative_to(ROOT).as_posix()
                 for p in (ROOT / "dmtpu_torch").rglob("*.py")) + ["chip_smoke.py"]


def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module" \
                and node.args and isinstance(node.args[0], ast.Constant):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


def test_the_port_has_its_new_modules():
    for name in ("dmtpu_torch/diffusions/flow.py", "dmtpu_torch/diffusions/flow_dpm.py",
                 "dmtpu_torch/models/mmdit.py", "dmtpu_torch/convert/zoo.py",
                 "dmtpu_torch/scripts/sample_mmdit.py", "dmtpu_torch/scripts/train_mmdit.py",
                 "dmtpu_torch/models/sdxl.py", "dmtpu_torch/ui/sdxl.py",
                 "dmtpu_torch/models/modules.py", "dmtpu_torch/models/unet.py",
                 "dmtpu_torch/models/unet_categorial_adagn.py", "dmtpu_torch/diffusions/euler.py",
                 "dmtpu_torch/diffusions/heun.py", "dmtpu_torch/scripts/sample_uncond.py",
                 "dmtpu_torch/diffusions/ddpm_ip.py", "dmtpu_torch/scripts/train_ddpm.py",
                 "dmtpu_torch/ops/resize_right.py", "dmtpu_torch/diffusions/guidance/ilvr.py",
                 "dmtpu_torch/diffusions/guidance/clip_guidance.py", "dmtpu_torch/utils/mask.py",
                 "dmtpu_torch/scripts/_editing.py", "dmtpu_torch/scripts/sample_sdedit.py",
                 "dmtpu_torch/scripts/sample_ilvr.py",
                 "dmtpu_torch/scripts/sample_mask_guidance.py",
                 "dmtpu_torch/scripts/sample_ddib.py",
                 "dmtpu_torch/scripts/sample_clip_guidance.py",
                 "dmtpu_torch/scripts/encode_prompts.py", "dmtpu_torch/eval/__init__.py",
                 "dmtpu_torch/eval/fid.py", "dmtpu_torch/eval/inception.py",
                 "dmtpu_torch/scripts/evaluate.py", "dmtpu_torch/scripts/accept.py"):
        assert name in SOURCES


@pytest.mark.parametrize("source", SOURCES)
def test_no_jax_flax_or_dmtpu_import(source):
    assert not _imported_roots(ROOT / source) & FORBIDDEN
