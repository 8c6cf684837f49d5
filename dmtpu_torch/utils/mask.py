"""Random masks for inpainting (numpy and PIL).

Counterpart of ``dmtpu/utils/mask.py``, with the same numpy and PIL draws, so
its masks are byte-identical to the JAX package's.  Seven mask families
(reference: utils/mask.py): dir / center / rect / brush / half /
every-second-line / sr2x, composable by intersection, with the per-item
seeding ``seed(item + 3407)`` for evaluation (reference :150-154).  Masks are
[H, W, 1] float32 numpy arrays, 1 = known, 0 = hole; a CLI moves them to
[B, 1, H, W] tensors, the layout ``MaskGuidance`` takes.
"""
from __future__ import annotations

import math
import os
from typing import List, Optional, Tuple, Union

import numpy as np
from PIL import Image, ImageDraw


class MaskGenerator:
    """(reference: utils/mask.py:56-284)"""

    def __init__(
        self,
        mask_type: Union[str, List[str]] = "center",
        dir_path: Optional[str] = None,
        dir_invert_color: bool = False,
        center_length_ratio: Tuple[float, float] = (0.25, 0.25),
        rect_num: Tuple[int, int] = (1, 4),
        rect_length_ratio: Tuple[float, float] = (0.2, 0.8),
        brush_num: Tuple[int, int] = (1, 9),
        brush_n_vertex: Tuple[int, int] = (4, 18),
        brush_mean_angle: float = 2 * math.pi / 5,
        brush_angle_range: float = 2 * math.pi / 15,
        brush_width_ratio: Tuple[float, float] = (0.02, 0.1),
        is_train: bool = False,
    ):
        self.mask_type = [mask_type] if isinstance(mask_type, str) else list(set(mask_type))
        self.dir_invert_color = dir_invert_color
        self.center_length_ratio = center_length_ratio
        self.rect_num = rect_num
        self.rect_length_ratio = rect_length_ratio
        self.brush_num = brush_num
        self.brush_n_vertex = brush_n_vertex
        self.brush_mean_angle = brush_mean_angle
        self.brush_angle_range = brush_angle_range
        self.brush_width_ratio = brush_width_ratio
        self.is_train = is_train

        if "dir" in self.mask_type:
            dir_path = os.path.expanduser(dir_path)
            assert os.path.isdir(dir_path), f"{dir_path} is not a valid directory"
            exts = (".png", ".jpg", ".jpeg")
            paths = []
            for curdir, _, files in os.walk(dir_path):
                for f in files:
                    if os.path.splitext(f)[1].lower() in exts:
                        paths.append(os.path.join(curdir, f))
            self.mask_paths = sorted(paths)

    def sample(self, H: int, W: int, item: Optional[int] = None) -> np.ndarray:
        """Returns [H, W, 1] float32 mask; 1 = known, 0 = hole."""
        if not self.is_train and item is not None:
            rng = np.random.RandomState((int(item) + 3407) % (2 ** 31))
        else:
            rng = np.random

        mask = np.ones((H, W), bool)
        for t in self.mask_type:
            if t == "dir":
                m = self._sample_dir(H, W, rng)
            elif t == "center":
                m = self._sample_center(H, W, rng)
            elif t == "rect":
                m = self._sample_rectangles(H, W, rng)
            elif t == "brush":
                m = self._sample_brushes(H, W, rng)
            elif t == "half":
                m = self._sample_half(H, W, rng)
            elif t == "every-second-line":
                m = self._sample_every_second_line(H, W)
            elif t == "sr2x":
                m = self._sample_sr2x(H, W)
            else:
                raise ValueError(f"mask type {t} is not supported")
            mask &= m
        return mask[:, :, None].astype(np.float32)

    def _sample_dir(self, H, W, rng) -> np.ndarray:
        path = self.mask_paths[rng.randint(0, len(self.mask_paths))]
        img = Image.open(path).convert("L").resize((W, H), Image.BILINEAR)
        arr = np.asarray(img, np.float32) / 255.0
        return (arr < 0.5) if self.dir_invert_color else (arr >= 0.5)

    def _sample_center(self, H, W, rng) -> np.ndarray:
        lo, hi = self.center_length_ratio
        ratio = rng.rand() * (hi - lo) + lo
        h, w = int(ratio * H), int(ratio * W)
        mask = np.ones((H, W), bool)
        mask[H // 2 - h // 2:H // 2 + h // 2, W // 2 - w // 2:W // 2 + w // 2] = False
        return mask

    def _sample_rectangles(self, H, W, rng) -> np.ndarray:
        lo_n, hi_n = self.rect_num
        lo_r, hi_r = self.rect_length_ratio
        mask = np.ones((H, W), bool)
        for _ in range(rng.randint(lo_n, hi_n + 1)):
            h = rng.randint(int(lo_r * H), int(hi_r * H) + 1)
            w = rng.randint(int(lo_r * W), int(hi_r * W) + 1)
            y = rng.randint(0, H - h + 1)
            x = rng.randint(0, W - w + 1)
            mask[y:y + h, x:x + w] = False
        return mask

    def _sample_brushes(self, H, W, rng) -> np.ndarray:
        """(reference: utils/mask.py:211-257)"""
        lo_n, hi_n = self.brush_num
        lo_v, hi_v = self.brush_n_vertex
        min_w = int(self.brush_width_ratio[0] * min(H, W))
        max_w = int(self.brush_width_ratio[1] * min(H, W))
        avg_r = math.sqrt(H * H + W * W) / 8
        img = Image.new("L", (W, H), 255)
        for _ in range(rng.randint(lo_n, hi_n + 1)):
            n_vertex = rng.randint(lo_v, hi_v + 1)
            width = rng.randint(min_w, max_w + 1)
            min_a = self.brush_mean_angle - rng.rand() * self.brush_angle_range
            max_a = self.brush_mean_angle + rng.rand() * self.brush_angle_range
            vertex = [(rng.randint(0, W), rng.randint(0, H))]
            for j in range(n_vertex):
                angle = rng.rand() * (max_a - min_a) + min_a
                if j % 2 == 0:
                    angle = 2 * math.pi - angle
                r = float(np.clip(rng.normal(avg_r, avg_r // 2), 0, 2 * avg_r))
                nx = min(max(vertex[-1][0] + r * math.cos(angle), 0), W)
                ny = min(max(vertex[-1][1] + r * math.sin(angle), 0), H)
                vertex.append((nx, ny))
            draw = ImageDraw.Draw(img)
            draw.line(vertex, fill=0, width=width)
            for v in vertex:
                draw.ellipse((v[0] - width // 2, v[1] - width // 2,
                              v[0] + width // 2, v[1] + width // 2), fill=0)
            if rng.rand() > 0.5:
                img = img.transpose(Image.Transpose.FLIP_LEFT_RIGHT)
            if rng.rand() > 0.5:
                img = img.transpose(Image.Transpose.FLIP_TOP_BOTTOM)
        if rng.rand() > 0.5:
            img = img.transpose(Image.Transpose.FLIP_LEFT_RIGHT)
        if rng.rand() > 0.5:
            img = img.transpose(Image.Transpose.FLIP_TOP_BOTTOM)
        return np.asarray(img, np.float32) / 255.0 >= 0.5

    @staticmethod
    def _sample_half(H, W, rng) -> np.ndarray:
        mask = np.ones((H, W), bool)
        d = rng.randint(0, 4)
        if d == 0:
            mask[:H // 2] = False
        elif d == 1:
            mask[H // 2:] = False
        elif d == 2:
            mask[:, :W // 2] = False
        else:
            mask[:, W // 2:] = False
        return mask

    @staticmethod
    def _sample_every_second_line(H, W) -> np.ndarray:
        mask = np.ones((H, W), bool)
        mask[::2] = False
        return mask

    @staticmethod
    def _sample_sr2x(H, W) -> np.ndarray:
        mask = np.ones((H, W), bool)
        mask[::2] = False
        mask[:, ::2] = False
        return mask


class DatasetWithMask:
    """Wrap a dataset to yield (image, mask) pairs.  (reference: utils/mask.py:11-53)"""

    def __init__(self, dataset, mask_type: Union[str, List[str]] = "center", **kwargs):
        self.dataset = dataset
        self.mask_generator = MaskGenerator(mask_type=mask_type, **kwargs)

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, item: int):
        image = self.dataset[item]
        image = image[0] if isinstance(image, (tuple, list)) else image
        h, w = image.shape[:2]
        mask = self.mask_generator.sample(int(h), int(w), item)
        return image, mask
