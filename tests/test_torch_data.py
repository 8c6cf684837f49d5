"""dmtpu_torch.data against dmtpu.data: the loader's batches, the image
transform and the captioned datasets give the same values (exactly: the
same numpy and PIL operations on the same inputs)."""
import threading

import numpy as np
import pytest
from PIL import Image

from dmtpu.data import DataLoader as JaxDataLoader
from dmtpu.data.captioned import CaptionedImageDir as JaxCaptionedImageDir
from dmtpu.data.captioned import SyntheticCaptioned as JaxSyntheticCaptioned
from dmtpu.data.transforms import ImageTransform as JaxImageTransform
from dmtpu_torch.data import DataLoader
from dmtpu_torch.data.captioned import CaptionedImageDir, SyntheticCaptioned
from dmtpu_torch.data.datasets import extract_images
from dmtpu_torch.data.transforms import ImageTransform
from dmtpu_torch.utils.config import instantiate_from_config


class _Indexed:
    """Item i is {"image": an array filled with i, "caption": "i"}."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"image": np.full((2, 2, 1), i, np.float32), "caption": str(i)}


def _batches(loader, epochs):
    out = []
    for _ in range(epochs):
        out.append([(b["image"][:, 0, 0, 0].tolist(), list(b["caption"])) for b in loader])
    return out


@pytest.mark.parametrize("num_shards", [1, 2])
@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (False, False)])
def test_loader_batches_match_jax(num_shards, shuffle, drop_last):
    ds = _Indexed(13)
    per_shard = []
    for shard in range(num_shards):
        kw = dict(batch_size=3, shuffle=shuffle, drop_last=drop_last, seed=5,
                  num_shards=num_shards, shard_index=shard)
        want = _batches(JaxDataLoader(ds, num_workers=0, **kw), 2)
        for workers in (0, 2):
            loader = DataLoader(ds, num_workers=workers, prefetch=2, **kw)
            got = _batches(loader, 2)
            assert got == want and len(got[0]) == len(loader)
        per_shard.append(len(got[0]))
        if shuffle:  # two epochs, two orders
            assert got[0] != got[1]
    assert len(set(per_shard)) == 1  # every shard takes as many steps


class _Failing(_Indexed):
    def __getitem__(self, i):
        if i == 7:
            raise OSError("unreadable item 7")
        return super().__getitem__(i)


def _producers():
    return [t for t in threading.enumerate() if t.name == "DataLoader-producer"]


def test_producer_error_is_raised_in_the_consumer():
    loader = DataLoader(_Failing(12), batch_size=2, shuffle=False, num_workers=2)
    with pytest.raises(OSError, match="unreadable item 7"):
        for _ in loader:
            pass
    # an abandoned iterator stops its producer
    it = iter(DataLoader(_Indexed(40), batch_size=2, shuffle=False, num_workers=2, prefetch=1))
    next(it)
    it.close()
    for t in _producers():
        t.join(timeout=5)
    assert not _producers()


@pytest.mark.parametrize("crop,flip_p", [(None, 0.0), (None, 1.0), ("center", 0.5), ("random", 0.5)])
def test_image_transform_matches_jax(crop, flip_p):
    rs = np.random.RandomState(0)
    img = Image.fromarray(rs.randint(0, 256, (23, 31, 3), np.uint8))
    for seed in range(3):
        want = JaxImageTransform(16, flip_p=flip_p, crop=crop)(img, np.random.RandomState(seed))
        got = ImageTransform(16, flip_p=flip_p, crop=crop)(img, np.random.RandomState(seed))
        assert got.dtype == np.float32 and got.shape == (16, 16, 3)
        np.testing.assert_array_equal(got, want)


def test_captioned_datasets_match_jax(tmp_path):
    root = tmp_path / "imgs"
    (root / "sub").mkdir(parents=True)
    rs = np.random.RandomState(1)
    for i, name in enumerate(["b.png", "a.jpg", "sub/c.png", "d.PNG"]):
        Image.fromarray(rs.randint(0, 256, (20, 24, 3), np.uint8)).save(root / name)
        if i % 2 == 0:
            (root / name).with_suffix(".txt").write_text(f" caption {i}\n")
    (root / "notes.txt").write_text("not an image")
    assert len(extract_images(str(root))) == 4
    conf = {"target": "dmtpu.data.captioned.CaptionedImageDir",
            "params": {"root": str(root), "img_size": 8, "default_caption": "fallback",
                       "flip_p": 0.0}}
    ds = instantiate_from_config(conf)
    want = JaxCaptionedImageDir(str(root), img_size=8, default_caption="fallback", flip_p=0.0)
    assert isinstance(ds, CaptionedImageDir) and len(ds) == len(want) == 4
    assert ds.img_paths == want.img_paths
    for i in range(4):
        a, b = ds[i], want[i]
        assert a["caption"] == b["caption"]
        np.testing.assert_array_equal(a["image"], b["image"])
    assert sorted(ds[i]["caption"] for i in range(4)) == ["caption 0", "caption 2", "fallback",
                                                          "fallback"]
    with pytest.raises(ValueError, match="not a valid directory"):
        CaptionedImageDir(str(tmp_path / "none"), img_size=8)

    syn, jsyn = SyntheticCaptioned(img_size=8, n=6, seed=3), JaxSyntheticCaptioned(img_size=8, n=6,
                                                                                     seed=3)
    assert len(syn) == 6
    for i in range(6):
        assert syn[i]["caption"] == jsyn[i]["caption"]
        np.testing.assert_array_equal(syn[i]["image"], jsyn[i]["image"])
    batch = next(iter(DataLoader(ds, batch_size=4, shuffle=False, num_workers=0)))
    assert batch["image"].shape == (4, 8, 8, 3) and list(batch["caption"])[1] == ds[1]["caption"]
