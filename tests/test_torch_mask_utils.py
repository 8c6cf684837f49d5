"""dmtpu_torch.utils.mask against dmtpu.utils.mask: the same masks, byte for byte.

Both draw with numpy's RandomState seeded by ``item + 3407`` and paint with
PIL, so every family, at every item and size, must give the same bytes.
"""
import numpy as np
import pytest

from dmtpu.utils import mask as jmask
from dmtpu_torch.utils import mask as tmask

FAMILIES = ["center", "rect", "brush", "half", "every-second-line", "sr2x", "dir",
            ["center", "brush"]]


@pytest.fixture(scope="module")
def mask_dir(tmp_path_factory):
    """Four seeded grey PNGs of several sizes: the ``dir`` family's masks."""
    from PIL import Image

    root = tmp_path_factory.mktemp("masks")
    rs = np.random.RandomState(0)
    for i, (h, w) in enumerate([(32, 32), (40, 24), (64, 64), (17, 50)]):
        Image.fromarray(rs.randint(0, 256, (h, w), dtype=np.uint8)).save(root / f"{i}.png")
    return str(root)


@pytest.mark.parametrize("size", [(64, 64), (48, 80), (256, 256)])
@pytest.mark.parametrize("family", FAMILIES, ids=str)
def test_masks_are_byte_identical(family, size, mask_dir):
    kw = dict(dir_path=mask_dir) if "dir" in family else {}
    jm, tm = jmask.MaskGenerator(family, **kw), tmask.MaskGenerator(family, **kw)
    for item in (0, 1, 7, 1000):
        got, want = tm.sample(*size, item=item), jm.sample(*size, item=item)
        assert got.dtype == want.dtype == np.float32 and got.shape == size + (1,)
        assert got.tobytes() == want.tobytes(), (family, size, item)
    assert 0 < got.mean() <= 1


def test_dir_family_inverted_and_the_brush_knobs(mask_dir):
    for kw in (dict(mask_type="dir", dir_path=mask_dir, dir_invert_color=True),
               dict(mask_type="brush", brush_num=(3, 3), brush_width_ratio=(0.05, 0.2)),
               dict(mask_type="rect", rect_num=(2, 5), rect_length_ratio=(0.1, 0.4)),
               dict(mask_type="center", center_length_ratio=(0.1, 0.6))):
        want = jmask.MaskGenerator(**kw).sample(72, 72, item=3)
        assert tmask.MaskGenerator(**kw).sample(72, 72, item=3).tobytes() == want.tobytes()


def test_dataset_with_mask_gives_the_same_pairs():
    rs = np.random.RandomState(1)
    images = [rs.rand(32, 48, 3).astype(np.float32) * 2 - 1 for _ in range(4)]
    labelled = [(img, i) for i, img in enumerate(images)]
    for data in (images, labelled):
        jd = jmask.DatasetWithMask(data, mask_type="brush")
        td = tmask.DatasetWithMask(data, mask_type="brush")
        assert len(td) == len(jd) == 4
        for i in range(4):
            (ti, tmk), (ji, jmk) = td[i], jd[i]
            assert ti is ji and tmk.tobytes() == jmk.tobytes() and tmk.shape == (32, 48, 1)


def test_an_unknown_family_is_refused():
    with pytest.raises(ValueError, match="not supported"):
        tmask.MaskGenerator("stars").sample(8, 8, item=0)
