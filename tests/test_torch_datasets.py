"""dmtpu_torch.data.datasets against dmtpu.data.datasets: every reader gives
the same items (exactly: the same numpy and PIL operations on the same
files) and the same labels as its JAX twin, on files the test writes: CIFAR
pickle batches, MNIST idx files (plain and ``.gz``), an image folder, the
CelebA-HQ and ImageNet layouts; ``Synthetic`` by seed.  The reference's
targets resolve onto the port's readers through the registry.  Random flips
and crops draw from ``np.random``, seeded alike before each item."""
import gzip
import os
import pickle
import struct

import numpy as np
import pytest
from PIL import Image

from dmtpu.data import datasets as jds
from dmtpu_torch.data import DataLoader
from dmtpu_torch.data import datasets as tds
from dmtpu_torch.utils.config import instantiate_from_config


def _same_items(got, want, n=None):
    assert len(got) == len(want)
    for i in range(n or len(want)):
        np.random.seed(i)
        a = got[i]
        np.random.seed(i)
        b = want[i]
        if isinstance(b, tuple):
            assert isinstance(a, tuple) and a[1] == b[1] and isinstance(a[1], int)
            a, b = a[0], b[0]
        assert a.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def _png(path, rs, size=(20, 24)):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(rs.randint(0, 256, size + (3,), np.uint8)).save(path)


def _cifar(root, rs, n=3):
    base = root / "cifar-10-batches-py"
    base.mkdir(parents=True)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        blob = {b"data": rs.randint(0, 256, (n, 3072), np.uint8),
                b"labels": rs.randint(0, 10, n).tolist()}
        with open(base / name, "wb") as f:
            pickle.dump(blob, f)


@pytest.mark.parametrize("split,img_size,transform_type", [
    ("train", 32, "default"), ("train", 16, "default"), ("test", 32, "default"),
    ("train", 32, "none")])
def test_cifar10_matches_jax(tmp_path, split, img_size, transform_type):
    _cifar(tmp_path, np.random.RandomState(0))
    kw = dict(img_size=img_size, split=split, transform_type=transform_type)
    got, want = tds.CIFAR10(str(tmp_path), **kw), jds.CIFAR10(str(tmp_path), **kw)
    assert len(got) == (15 if split == "train" else 3) and got.flip_p == want.flip_p
    _same_items(got, want)
    for i in range(3):  # a caller's generator decides the flip
        a, b = got.__getitem__(i, np.random.RandomState(7)), want.__getitem__(
            i, np.random.RandomState(7))
        np.testing.assert_array_equal(a[0], b[0])
    # the batches directory itself as the root
    np.testing.assert_array_equal(
        tds.CIFAR10(str(tmp_path / "cifar-10-batches-py"), split=split).images, want.images)
    with pytest.raises(ValueError, match="Invalid split"):
        tds.CIFAR10(str(tmp_path), split="valid")


def _idx(path, arr, gz):
    head = struct.pack(">I", 0x0800 | arr.ndim) + struct.pack(">" + "I" * arr.ndim, *arr.shape)
    with (gzip.open if gz else open)(str(path) + (".gz" if gz else ""), "wb") as f:
        f.write(head + arr.astype(np.uint8).tobytes())


@pytest.mark.parametrize("gz,layout,img_size", [(False, "raw", 28), (True, "flat", 28),
                                                 (False, "flat", 14)])
def test_mnist_matches_jax(tmp_path, gz, layout, img_size):
    rs = np.random.RandomState(1)
    raw = tmp_path / "MNIST" / "raw" if layout == "raw" else tmp_path
    raw.mkdir(parents=True, exist_ok=True)
    for split, n in (("train", 5), ("test", 2)):
        img_f, lbl_f = tds.MNIST._FILES[split]
        _idx(raw / img_f, rs.randint(0, 256, (n, 28, 28)), gz)
        _idx(raw / lbl_f, rs.randint(0, 10, n), gz)
    for split in ("train", "test"):
        got = tds.MNIST(str(tmp_path), img_size=img_size, split=split)
        want = jds.MNIST(str(tmp_path), img_size=img_size, split=split)
        assert got[0][0].shape == (img_size, img_size, 1)
        _same_items(got, want)


@pytest.mark.parametrize("cache", [False, True])
@pytest.mark.parametrize("img_size,flip_p", [(None, 0.0), (8, 0.5)])
def test_image_dir_matches_jax(tmp_path, cache, img_size, flip_p):
    rs = np.random.RandomState(2)
    for name in ("b.png", "a.jpg", "sub/c.png", "d.BMP"):
        _png(str(tmp_path / name), rs)
    (tmp_path / "notes.txt").write_text("not an image")
    kw = dict(img_size=img_size, flip_p=flip_p, cache=cache)
    got, want = tds.ImageDir(str(tmp_path), **kw), jds.ImageDir(str(tmp_path), **kw)
    assert got.img_paths == want.img_paths and len(got) == 4
    _same_items(got, want)
    _same_items(got, want)  # again, from the cache where there is one
    with pytest.raises(ValueError, match="not a valid directory"):
        tds.ImageDir(str(tmp_path / "none"))


@pytest.mark.parametrize("split", ["train", "valid", "test", "all"])
@pytest.mark.parametrize("numbering", ["celeba", "mask_hq"])
def test_celebahq_matches_jax(tmp_path, split, numbering):
    rs = np.random.RandomState(3)
    img_root = tmp_path / "CelebA-HQ-img"
    if numbering == "celeba":  # files named by their original-CelebA number
        names = [5, 162770, 162771, 170000, 182638, 200000]
    else:  # CelebAMask-HQ indices, translated through the mapping file
        names = [0, 1, 2, 3, 4, 5]
        orig = [5, 162770, 162771, 170000, 182638, 200000]
        (tmp_path / "CelebA-HQ-to-CelebA-mapping.txt").write_text(
            "idx orig_idx orig_file\n" + "".join(f"{i} {o - 1} {o:06d}.jpg\n"
                                                 for i, o in zip(names, orig)))
    for n in names:
        _png(str(img_root / f"{n}.png"), rs, size=(12, 12))
    got = tds.CelebAHQ(str(tmp_path), img_size=8, split=split)
    want = jds.CelebAHQ(str(tmp_path), img_size=8, split=split)
    assert got.img_paths == want.img_paths
    assert len(got) == {"train": 2, "valid": 2, "test": 2, "all": 6}[split]
    _same_items(got, want)


def test_celebahq_refuses_what_its_twin_refuses(tmp_path):
    with pytest.raises(ValueError, match="not an existing directory"):
        tds.CelebAHQ(str(tmp_path), img_size=8)
    _png(str(tmp_path / "CelebA-HQ-img" / "face.png"), np.random.RandomState(4))
    with pytest.raises(ValueError, match="numeric filenames"):
        tds.CelebAHQ(str(tmp_path), img_size=8)
    with pytest.raises(ValueError, match="Invalid split"):
        tds.CelebAHQ(str(tmp_path), img_size=8, split="dev")


@pytest.mark.parametrize("split,transform_type", [
    ("train", "default"), ("valid", "default"), ("test", "resize"), ("train", "none")])
def test_imagenet_matches_jax(tmp_path, split, transform_type):
    rs = np.random.RandomState(5)
    for folder in ("train", "val", "test"):
        for cls in ("n01", "n02"):
            for i in range(2):
                _png(str(tmp_path / folder / cls / f"{cls}_{i}.JPEG"), rs, size=(18, 26))
    kw = dict(img_size=12, split=split, transform_type=transform_type)
    got, want = tds.ImageNet(str(tmp_path), **kw), jds.ImageNet(str(tmp_path), **kw)
    assert got.img_paths == want.img_paths and len(got) == 4
    _same_items(got, want)
    with pytest.raises(ValueError, match="Invalid transform_type"):
        tds.ImageNet(str(tmp_path), img_size=12, transform_type="warp")


@pytest.mark.parametrize("num_classes", [None, 7])
def test_synthetic_matches_jax_by_seed(num_classes):
    kw = dict(img_size=8, channels=4, n=6, num_classes=num_classes, seed=9)
    got, want = tds.Synthetic(**kw), jds.Synthetic(**kw)
    _same_items(got, want)
    assert not np.array_equal(tds.Synthetic(**dict(kw, seed=10)).images, got.images)
    batch = next(iter(DataLoader(got, batch_size=4, shuffle=False, num_workers=0)))
    if num_classes:
        images, labels = batch
        assert images.shape == (4, 8, 8, 4) and labels.tolist() == want.labels[:4].tolist()
    else:
        assert batch.shape == (4, 8, 8, 4)


@pytest.mark.parametrize("target,cls", [
    ("datasets.ImageDir.ImageDir", tds.ImageDir), ("datasets.mnist.MNIST", tds.MNIST),
    ("datasets.cifar10.CIFAR10", tds.CIFAR10), ("datasets.celebahq.CelebAHQ", tds.CelebAHQ),
    ("datasets.imagenet.ImageNet", tds.ImageNet), ("datasets.synthetic.Synthetic", tds.Synthetic),
    ("dmtpu.data.datasets.CIFAR10", tds.CIFAR10), ("dmtpu.data.image_dir.ImageDir", tds.ImageDir)])
def test_reference_targets_resolve_onto_the_readers(target, cls):
    from dmtpu_torch.utils.config import resolve_target

    assert resolve_target(target) is cls
    if cls is tds.Synthetic:
        ds = instantiate_from_config({"target": target, "params": {"img_size": 4, "n": 3,
                                                                   "num_classes": 2}})
        assert isinstance(ds, cls) and len(ds) == 3 and ds[0][0].shape == (4, 4, 3)
