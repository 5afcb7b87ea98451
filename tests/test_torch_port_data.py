"""The PyTorch port's dataset pipeline against the JAX package's.

One synthetic dataset is written twice from the same seed, once by each
package's writer; the readers, the collation, the sampler and the pipeline
of both packages must give the same arrays (they are numpy on both sides).
"""

import filecmp
import importlib
import os
import sys

import numpy as np
import pytest
import torch

from videocad_tpu.data import dataset as jax_dataset
from videocad_tpu.data import pipeline as jax_pipeline
from videocad_tpu.data import synthetic as jax_synthetic
from videocad_tpu.etl import dataset_gen as jax_dataset_gen
from videocad_tpu.utils import io as jax_io
from videocad_tpu_torch.data import dataset as port_dataset
from videocad_tpu_torch.data import pipeline as port_pipeline
from videocad_tpu_torch.data import synthetic as port_synthetic
from videocad_tpu_torch.utils import io as port_io

# Both packages' __init__ re-export the function `collate` over the module.
jax_collate = importlib.import_module("videocad_tpu.data.collate")
port_collate = importlib.import_module("videocad_tpu_torch.data.collate")


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """(JAX writer's directory, port writer's directory, split map)."""
    root = tmp_path_factory.mktemp("stores")
    kw = dict(num_sequences=12, min_len=5, max_len=20, image_size=16, seed=3)
    dirs = []
    for name, writer in (("jax", jax_synthetic.write_synthetic_dataset),
                         ("port", port_synthetic.write_synthetic_dataset)):
        out = root / name
        out.mkdir()
        split = writer(str(out), split_path=str(out / "dataset_split.json"),
                       **kw)
        dirs.append(str(out))
    return dirs[0], dirs[1], split


def _files(base):
    return sorted(os.path.relpath(os.path.join(r, n), base)
                  for r, _d, names in os.walk(base) for n in names)


def _assert_batches_equal(got, want):
    assert set(got) == set(want)
    for key, value in want.items():
        if isinstance(value, np.ndarray):
            assert got[key].dtype == value.dtype, key
            np.testing.assert_array_equal(got[key], value, err_msg=key)
        else:
            assert got[key] == value, key


def test_the_writers_write_the_same_files(stores):
    jax_dir, port_dir, split = stores
    assert _files(jax_dir) == _files(port_dir)
    for rel in _files(jax_dir):
        if rel.endswith(".png"):
            np.testing.assert_array_equal(
                port_dataset.read_image(os.path.join(port_dir, rel)),
                jax_dataset.read_image(os.path.join(jax_dir, rel)))
        else:   # pickles and the split json: byte for byte
            assert filecmp.cmp(os.path.join(jax_dir, rel),
                               os.path.join(port_dir, rel), shallow=False), rel
    assert sorted(set(split.values())) == ["test", "train", "val"]
    assert port_synthetic.shard_path(port_dir, "00000003", "pkl", "data") == \
        jax_dataset_gen.shard_path(port_dir, "00000003", "pkl", "data")
    assert port_synthetic.shard_path(port_dir, "00000003", "x", "") == \
        jax_dataset_gen.shard_path(port_dir, "00000003", "x", "")


def test_split_ids_scan_and_image_loader_equal_jax(stores):
    jax_dir, port_dir, _ = stores
    split_path = os.path.join(port_dir, "dataset_split.json")
    splits = port_dataset.load_split_ids(split_path)
    assert splits == jax_dataset.load_split_ids(split_path)
    def rel(paths, base):
        return [os.path.relpath(p, base) for p in paths]

    for ids in (None, splits["train"], []):
        assert rel(port_dataset.scan_dataset(port_dir, ids), port_dir) == \
            rel(jax_dataset.scan_dataset(jax_dir, ids), jax_dir)
    for enable_random in (False, True):
        port_loader = port_dataset.ImageLoader(port_dir, enable_random, seed=5)
        jax_loader = jax_dataset.ImageLoader(jax_dir, enable_random, seed=5)
        for _ in range(3):
            for file_id in splits["val"]:
                assert os.path.relpath(port_loader.get_path(file_id),
                                       port_dir) == os.path.relpath(
                    jax_loader.get_path(file_id), jax_dir)
    with pytest.raises(FileNotFoundError, match="No PNG"):
        port_loader.get_path("nope")


@pytest.mark.parametrize("image_size", [None, 16, 24])
def test_dataset_items_equal_jax(stores, image_size):
    jax_dir, port_dir, _ = stores
    want = jax_dataset.VideoCADDataset(jax_dir, image_size=image_size)
    got = port_dataset.VideoCADDataset(port_dir, image_size=image_size)
    assert len(got) == len(want) == 12
    for i in range(len(want)):
        assert got.sequence_id(i) == want.sequence_id(i)
        _assert_batches_equal(got[i], want[i])
    got.validate(range(3))


def test_resize_u8_equals_jax():
    img = np.random.default_rng(0).integers(0, 256, (20, 28, 3),
                                            dtype=np.uint8)
    for size in ((20, 28), (16, 16), (40, 30)):
        np.testing.assert_array_equal(port_dataset.resize_u8(img, size),
                                      jax_dataset.resize_u8(img, size))


def test_dataset_refuses_what_is_not_ported(stores, tmp_path, monkeypatch):
    """An empty directory, and the GenCAD branch where OpenCV is missing
    (the card's machine has none): a clear error naming cv2."""
    _, port_dir, _ = stores
    with pytest.raises(ValueError, match="No \\*_data.pkl"):
        port_dataset.VideoCADDataset(str(tmp_path))
    monkeypatch.setitem(sys.modules, "cv2", None)   # import cv2 fails
    data = port_dataset.VideoCADDataset(port_dir, gencad=True)
    with pytest.raises(ImportError, match="needs OpenCV \\(cv2\\)"):
        data[0]


def test_gencad_items_equal_jax(stores):
    """gencad=True: the CAD image is the 256 x 256 x 3 Canny edge image,
    byte for byte the JAX reader's."""
    jax_dir, port_dir, _ = stores
    want = jax_dataset.VideoCADDataset(jax_dir, gencad=True)
    got = port_dataset.VideoCADDataset(port_dir, gencad=True)
    for i in range(len(want)):
        item = got[i]
        assert item["cad_image"].shape == (256, 256, 3)
        assert item["cad_image"].dtype == np.uint8
        _assert_batches_equal(item, want[i])
    rgb = np.random.default_rng(2).integers(0, 256, (180, 300, 3),
                                            dtype=np.uint8)
    np.testing.assert_array_equal(port_dataset.gencad_cad_image(rgb),
                                  jax_dataset.gencad_cad_image(rgb))


def _write_views(root, ids, views, size, seed):
    from PIL import Image
    rng = np.random.default_rng(seed)
    for file_id in ids:
        os.makedirs(os.path.join(root, file_id[:4]), exist_ok=True)
        for view in views:
            Image.fromarray(rng.integers(0, 256, (size, size, 3),
                                         dtype=np.uint8)).save(
                os.path.join(root, file_id[:4], f"{file_id}_{view}.png"))


@pytest.mark.parametrize("image_size", [None, 12])
def test_multiview_items_equal_jax(stores, tmp_path, image_size):
    """view_ids: each item carries its views (V, H, W, 3), resized to the
    frames' resolution, byte for byte the JAX reader's; a missing view is
    reported up front by check_multiview_availability."""
    jax_dir, port_dir, split = stores
    views = ["05", "09"]
    _write_views(str(tmp_path), sorted(split), views, 20, seed=4)
    kw = dict(view_ids=views, multiview_dir=str(tmp_path),
              image_size=image_size)
    want = jax_dataset.VideoCADDataset(jax_dir, **kw)
    got = port_dataset.VideoCADDataset(port_dir, **kw)
    got.check_multiview_availability()
    side = image_size or 16
    for i in range(len(want)):
        item = got[i]
        assert item["multiview_images"].shape == (2, side, side, 3)
        _assert_batches_equal(item, want[i])
    batch = port_collate.collate([got[0], got[1]])
    assert batch["multiview_images"].shape == (2, 2, side, side, 3)
    first = sorted(split)[0]
    os.remove(os.path.join(str(tmp_path), first[:4], f"{first}_09.png"))
    for data in (got, want):
        with pytest.raises(ValueError, match="1 samples missing"):
            data.check_multiview_availability()


def test_bucket_length_and_pad_to_equal_jax():
    assert port_collate.DEFAULT_BUCKETS == jax_collate.DEFAULT_BUCKETS == (
        48, 96, 144, 192)
    for n in (1, 48, 49, 100, 192):
        assert port_collate.bucket_length(n) == jax_collate.bucket_length(n)
    with pytest.raises(ValueError, match="exceeds largest bucket"):
        port_collate.bucket_length(193)
    arr = np.arange(12, dtype=np.float32).reshape(4, 3)
    for length, fill in ((7, -1), (4, 0), (2, -1)):
        np.testing.assert_array_equal(
            port_collate.pad_to(arr, length, fill),
            jax_collate.pad_to(arr, length, fill))


@pytest.mark.parametrize("fixed_length", [None, 32])
def test_collate_equals_jax(stores, fixed_length):
    _, port_dir, _ = stores
    ds = port_dataset.VideoCADDataset(port_dir)
    items = [ds[i] for i in (0, 5, 7)]
    got = port_collate.collate(items, (8, 24), fixed_length)
    want = jax_collate.collate(items, (8, 24), fixed_length)
    _assert_batches_equal(got, want)
    length = fixed_length or 24
    assert got["frames"].shape[:2] == (3, length)
    n = items[0]["frames"].shape[0]
    assert (got["actions"][0, n:] == -1).all()
    assert (got["frames"][0, n:] == 0).all()
    np.testing.assert_array_equal(got["timesteps"][1], np.arange(length))


@pytest.mark.parametrize("seed,epoch,host_id,num_hosts,shuffle", [
    (42, 0, 0, 1, True), (42, 3, 0, 1, True), (7, 1, 1, 2, True),
    (7, 1, 0, 2, True), (0, 0, 0, 1, False), (1, 2, 2, 3, True),
])
def test_sharded_sampler_order_equals_jax(seed, epoch, host_id, num_hosts,
                                          shuffle):
    args = (29, 4, shuffle, seed, host_id, num_hosts)
    got = port_pipeline.ShardedSampler(*args)
    want = jax_pipeline.ShardedSampler(*args)
    assert got.num_batches() == want.num_batches()
    got_batches = [b.tolist() for b in got.epoch_batches(epoch)]
    assert got_batches == [b.tolist() for b in want.epoch_batches(epoch)]
    assert len(got_batches) == got.num_batches()


def test_pipeline_batches_equal_jax_and_any_worker_count(stores):
    jax_dir, port_dir, _ = stores
    kw = dict(batch_size=3, shuffle=True, seed=11, buckets=(8, 24))
    want = jax_pipeline.DataPipeline(jax_dataset.VideoCADDataset(jax_dir),
                                     num_workers=1, **kw)
    ds = port_dataset.VideoCADDataset(port_dir)
    one = port_pipeline.DataPipeline(ds, num_workers=1, **kw)
    four = port_pipeline.DataPipeline(ds, num_workers=4, prefetch=1, **kw)
    assert len(one) == len(want) == 4
    for epoch in (0, 1):
        want_batches = list(want.epoch(epoch))
        for pipe in (one, four):
            got_batches = list(pipe.epoch(epoch))
            assert len(got_batches) == len(want_batches)
            for got, ref in zip(got_batches, want_batches):
                _assert_batches_equal(got, ref)
    first = [b["ids"] for b in one.epoch(0)]
    assert first != [b["ids"] for b in one.epoch(1)]     # reshuffled
    # A consumer that stops early leaves no thread behind.
    it = four.epoch(0)
    next(it)
    it.close()


def test_device_prefetch_on_cpu_returns_every_batch_in_order(stores):
    _, port_dir, _ = stores
    pipe = port_pipeline.DataPipeline(port_dataset.VideoCADDataset(port_dir),
                                      batch_size=2, shuffle=False,
                                      buckets=(24,))
    source = list(pipe.epoch(0))
    for size in (1, 2, 5):
        out = list(port_pipeline.device_prefetch(iter(source), "cpu", size))
        assert len(out) == len(source) == 6
        for got, want in zip(out, source):
            assert got["ids"] == want["ids"]               # strings stay
            for key in ("frames", "actions", "cad_image", "timesteps"):
                assert isinstance(got[key], torch.Tensor)
                assert got[key].device.type == "cpu"
                np.testing.assert_array_equal(got[key].numpy(), want[key])
    assert list(port_pipeline.device_prefetch(iter([]), "cpu")) == []


def test_io_helpers_round_trip_and_equal_jax(tmp_path):
    data = {"a": [1, 2.5, "x"], "b": {"c": None}}
    port_io.save_json(data, str(tmp_path / "p" / "d.json"))
    jax_io.save_json(data, str(tmp_path / "j" / "d.json"))
    assert port_io.open_file(str(tmp_path / "p" / "d.json")) == \
        jax_io.open_file(str(tmp_path / "j" / "d.json"))
    assert port_io.load_json(str(tmp_path / "j" / "d.json")) == data
    port_io.save_pickle(data, str(tmp_path / "p" / "d.pkl"))
    assert jax_io.load_pickle(str(tmp_path / "p" / "d.pkl")) == data
    assert port_io.load_pickle(str(tmp_path / "p" / "d.pkl")) == data
