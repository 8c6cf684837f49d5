"""What the two sampling kinds share: a closed loop of requests, one client,
each request's images kept on the host for the check, stage marks on the
device, and the check itself: a sample of the finished images, drawn from
the seed, worked out again by the reference and compared level by level."""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from portbench import checks
from portbench.harness import Context, sub_seed


class SamplingCell:
    unit = "request"

    def __init__(self, ctx: Context):
        self.ctx, self.device = ctx, ctx.device
        self.params = ctx.workload["params"]
        self.batch = int(self.params["batch"])
        self.outputs: List[Tuple[Dict[str, Any], np.ndarray]] = []  # (request, uint8 images)
        self.stage_marks = None   # set by the profiled sub-window
        self.stages: List[tuple] = []
        self._last = None

    # --- the requests -------------------------------------------------------
    def request(self, i: int) -> Dict[str, Any]:
        """Request ``i`` of the window: its inputs, drawn from the seed."""
        raise NotImplementedError

    def serve(self, req: Dict[str, Any], on_stage) -> np.ndarray:
        """The program's uint8 images [N, H, W, 3] of ``req``."""
        raise NotImplementedError

    def run(self, i: int) -> int:
        req = self.request(i)
        self._last = None
        images = self.serve(req, self._on_stage)
        self.outputs.append((req, images))
        return len(images)

    def _on_stage(self, name: str) -> None:
        if self.stage_marks is None:
            return
        point = self.stage_marks.mark()
        if self._last is not None:
            self.stages.append((self._last, point, name))
        self._last = point

    # --- the check ------------------------------------------------------------
    def picks(self) -> List[Tuple[int, int]]:
        """(request, row) of the images compared: a sample drawn from the
        seed, one in each of as many equal strata of a request's rows, each
        from any finished request (so every part of a batch is looked at)."""
        n = int(self.ctx.workload["check"]["images"])
        rng = np.random.default_rng(sub_seed(self.ctx.seed, "check"))
        out = []
        for k in range(n):
            r = int(rng.integers(len(self.outputs)))
            rows = len(self.outputs[r][1])
            out.append((r, int(rng.integers(k * rows // n, max((k + 1) * rows // n,
                                                                  k * rows // n + 1)))))
        return out

    def reference_images(self, picks: Sequence[Tuple[int, int]],
                         precision: Optional[str]) -> np.ndarray:
        raise NotImplementedError

    def _reference(self, picks) -> np.ndarray:
        """The float32 reference's images of ``picks``, worked out once."""
        if getattr(self, "_ref", None) is None or self._ref[0] != picks:
            self._ref = (picks, self.reference_images(picks, None))
        return self._ref[1]

    def _numbers(self, images: Sequence[np.ndarray], ref: np.ndarray) -> List[tuple]:
        """``pixels_rms``: the RMS gap in levels over every pixel of the
        compared images (their per-image gaps pooled), with the worst image's
        gap beside it for the record."""
        gaps = np.array([checks.image_rms(img, ref[k]) for k, img in enumerate(images)])
        limit = self.limit("pixels_rms")
        self.all_numbers = {"pixels_rms": float(np.sqrt(np.mean(gaps ** 2))),
                            "image_rms_max": float(gaps.max())}
        self.failed = int(np.sum(gaps > limit))
        return [("pixels_rms", self.all_numbers["pixels_rms"], limit)]

    def check(self) -> List[tuple]:
        picks = self.picks()
        return self._numbers([self.outputs[r][1][j] for r, j in picks], self._reference(picks))

    def control(self, precision: str) -> List[tuple]:
        """The check's number with the reference in ``precision`` in the
        program's place."""
        picks = self.picks()
        return self._numbers(self.reference_images(picks, precision), self._reference(picks))

    def limit(self, name: str) -> float:
        return float(self.ctx.workload["check"]["limits"][name])

    def release(self) -> None:
        raise NotImplementedError


def request_seed(seed: int, i: int) -> int:
    return sub_seed(seed, "request", str(i))


def noise_rows(req_seed: int, shape: Sequence[int], rows: Sequence[int],
               device: torch.device) -> torch.Tensor:
    """Rows ``rows`` of the request's initial noise, drawn again as the
    request drew it: ``torch.randn(shape)`` from a generator on the device
    seeded with the request's seed."""
    gen = torch.Generator(device=device).manual_seed(req_seed)
    return torch.randn(*shape, generator=gen, device=device)[list(rows)]
