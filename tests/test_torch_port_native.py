"""The port's C++ ``.vcb`` loader bindings (``videocad_tpu_torch/data/
native.py``) and ``cli/train.py --native_loader``, against the JAX
package's bindings and the port's own ``DataPipeline``.

Both packages bind the same ``native/loader.cpp``; the port builds its own
library under ``build/native/`` and must never write into ``native/``.
Stores are written by the synthetic writer from a seed (16 x 16 frames).
"""

import argparse
import hashlib
import json
import os
import shutil
import struct

import numpy as np
import pytest

from videocad_tpu.data import native as jax_native
from videocad_tpu_torch.cli import train as port_cli
from videocad_tpu_torch.data import native
from videocad_tpu_torch.data.dataset import VideoCADDataset
from videocad_tpu_torch.data.pipeline import DataPipeline
from videocad_tpu_torch.data.synthetic import write_synthetic_dataset
from tests.helpers import TINY_CONFIG

REPO_NATIVE = native.REPO / "native"
VIEWS = ["05", "09"]


def _add_view_pngs(store, seed=11):
    """``<store>/<id[:4]>/<id>_<view>.png`` for every sequence."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    ids = sorted(name.split("_")[0] for _, _, names in os.walk(store)
                 for name in names if name.endswith("_data.pkl"))
    for file_id in ids:
        for view in VIEWS:
            Image.fromarray(rng.integers(0, 256, (16, 16, 3),
                                         dtype=np.uint8)).save(
                os.path.join(store, file_id[:4], f"{file_id}_{view}.png"))


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("port_native"))
    path = os.path.join(root, "pickles")
    write_synthetic_dataset(path, num_sequences=6, min_len=4, max_len=8,
                            image_size=16, seed=3,
                            split_path=os.path.join(path,
                                                    "dataset_split.json"))
    _add_view_pngs(path)
    return root, path


def _native_tree():
    """(name -> (mtime_ns, sha256)) of every file under ``native/``. The
    JAX package's own build function rewrites ``native/libvcb_loader.so`` once
    when the source is newer: it runs first, so that only a write of the
    port's would show."""
    jax_native.build_library()
    return {name: (os.stat(REPO_NATIVE / name).st_mtime_ns,
                   hashlib.sha256((REPO_NATIVE / name).read_bytes())
                   .hexdigest())
            for name in sorted(os.listdir(REPO_NATIVE))}


def _rows(seed, t=5, hw=8, views=0, cad_shape=None):
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, (t, hw, hw, 3), dtype=np.uint8)
    cad = rng.integers(0, 256, cad_shape or (hw, hw, 3), dtype=np.uint8)
    actions = rng.integers(-1, 1000, (t, 7)).astype(np.int32)
    mv = (rng.integers(0, 256, (views, hw, hw, 3), dtype=np.uint8)
          if views else None)
    return frames, cad, actions, mv


def test_build_lands_in_build_and_leaves_native_untouched(tmp_path,
                                                          monkeypatch):
    before = _native_tree()
    path = native.build_library(force=True)
    assert os.path.dirname(path) == str(native.BUILD_DIR)
    assert os.path.basename(path).startswith("libvcb_loader-")
    assert native.load_library() is native.load_library()
    assert _native_tree() == before
    assert not [n for n in os.listdir(native.BUILD_DIR) if n.endswith(".tmp")]
    # A compile that fails raises with the compiler's output.
    bad = tmp_path / "loader.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "out")
    with pytest.raises(RuntimeError, match="compile failed.*\n.*error"):
        native.build_library()
    assert not list((tmp_path / "out").iterdir())


@pytest.mark.parametrize("version", [1, 2, 3])
def test_vcb_round_trip(tmp_path, version):
    frames, cad, actions, views = _rows(
        version, views=2 if version == 2 else 0,
        cad_shape=(12, 10, 3) if version == 3 else None)
    path = str(tmp_path / "seq.vcb")
    native.write_vcb(path, cad, frames, actions, views=views)
    with open(path, "rb") as f:
        assert struct.unpack("<7I", f.read(28))[1] == version
    pipe = native.NativePipeline(
        [path], batch_size=1, bucket_len=8, image_shape=(8, 8, 3),
        num_views=2 if version == 2 else 0, cad_shape=cad.shape,
        shuffle=False)
    batch = next(iter(pipe.epoch(0)))
    np.testing.assert_array_equal(batch["frames"][0, :5], frames)
    np.testing.assert_array_equal(batch["cad_image"][0], cad)
    np.testing.assert_array_equal(batch["actions"][0, :5],
                                  actions.astype(np.float32))
    # Padding: frames 0, actions -1.
    assert (batch["frames"][0, 5:] == 0).all()
    assert (batch["actions"][0, 5:] == -1).all()
    if version == 2:
        np.testing.assert_array_equal(batch["multiview_images"][0], views)
    else:
        assert "multiview_images" not in batch
    # The JAX package's writer makes the same bytes.
    jax_path = str(tmp_path / "jax.vcb")
    jax_native.write_vcb(jax_path, cad, frames, actions, views=views)
    with open(path, "rb") as a, open(jax_path, "rb") as b:
        assert a.read() == b.read()


def test_guards_refuse_what_the_cpp_code_cannot_take(tmp_path):
    frames, cad, actions, _ = _rows(0)
    path = str(tmp_path / "seq.vcb")
    # A shorter actions array would be a heap over-read in the writer.
    with pytest.raises(ValueError, match="actions must be"):
        native.write_vcb(path, cad, frames, actions[:3])
    with pytest.raises(ValueError, match="cad must be"):
        native.write_vcb(path, cad[..., 0], frames, actions)
    native.write_vcb(path, cad, frames, actions)
    kw = dict(bucket_len=8, image_shape=(8, 8, 3))
    # batch_size 0 is a SIGFPE in the C++ code.
    with pytest.raises(ValueError, match="batch_size and bucket_len"):
        native.NativePipeline([path], batch_size=0, **kw)
    with pytest.raises(ValueError, match="host_id 2 out of range"):
        native.NativePipeline([path], batch_size=1, host_id=2, num_hosts=2,
                              **kw)
    with pytest.raises(ValueError, match="no .vcb files"):
        native.NativePipeline([], batch_size=1, **kw)


@pytest.mark.parametrize("kind", ["plain", "views", "gencad"])
def test_converted_store_equals_jax_and_the_data_pipeline(store, tmp_path,
                                                          kind):
    """The port's converter writes the JAX converter's bytes; the port's
    NativePipeline gives the port's DataPipeline's batches and the JAX
    NativePipeline's, byte for byte, in order."""
    _, path = store
    kw = {"plain": {}, "views": {"view_ids": VIEWS},
          "gencad": {"gencad": True}}[kind]
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    assert native.convert_store_to_vcb(path, port_dir, **kw) == 6
    assert jax_native.convert_store_to_vcb(path, jax_dir, **kw) == 6
    port_paths = native.scan_vcb(port_dir)
    jax_paths = jax_native.scan_vcb(jax_dir)
    assert ([os.path.relpath(p, port_dir) for p in port_paths]
            == [os.path.relpath(p, jax_dir) for p in jax_paths])
    for a, b in zip(port_paths, jax_paths):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read(), a
    shape, views, cad_shape = port_cli._probe_shape(port_paths[0])
    pipe_kw = dict(batch_size=2, bucket_len=8, image_shape=shape,
                   num_views=views, cad_shape=cad_shape, shuffle=False)
    ours = list(native.NativePipeline(port_paths, **pipe_kw).epoch(0))
    theirs = list(jax_native.NativePipeline(jax_paths, **pipe_kw).epoch(0))
    python = list(DataPipeline(VideoCADDataset(path, **kw), batch_size=2,
                               buckets=(8,), shuffle=False).epoch(0))
    assert len(ours) == len(theirs) == len(python) == 3
    keys = ["frames", "actions", "cad_image", "timesteps"] + (
        ["multiview_images"] if kind == "views" else [])
    for got, want_jax, want_py in zip(ours, theirs, python):
        assert sorted(got) == sorted(want_jax)
        assert got["ids"] == want_jax["ids"] == want_py["ids"]
        for key in keys:
            for want in (want_jax, want_py):
                assert got[key].dtype == want[key].dtype, key
                np.testing.assert_array_equal(got[key], want[key],
                                              err_msg=key)
        if kind == "gencad":
            assert got["cad_image"].shape[1:] == (256, 256, 3)


def test_reshuffles_by_epoch_and_host_shards_are_disjoint(store, tmp_path):
    _, path = store
    native.convert_store_to_vcb(path, str(tmp_path / "vcb"))
    paths = native.scan_vcb(str(tmp_path / "vcb"))
    kw = dict(bucket_len=8, image_shape=(16, 16, 3), shuffle=True, seed=7)
    pipe = native.NativePipeline(paths, batch_size=2, **kw)
    ids0 = [b["ids"] for b in pipe.epoch(0)]
    assert ids0 == [b["ids"] for b in pipe.epoch(0)]
    assert ids0 != [b["ids"] for b in pipe.epoch(1)]
    seen = {}
    for host in (0, 1):
        shard = native.NativePipeline(paths, batch_size=1, host_id=host,
                                      num_hosts=2, **kw)
        assert len(shard) == len(paths) // 2
        seen[host] = {i for b in shard.epoch(0) for i in b["ids"]}
    assert seen[0].isdisjoint(seen[1])
    assert seen[0] | seen[1] == {os.path.basename(p).split("_")[0]
                                 for p in paths}


def test_bad_rows_are_counted_and_raise(store, tmp_path):
    _, path = store
    native.convert_store_to_vcb(path, str(tmp_path / "vcb"))
    paths = native.scan_vcb(str(tmp_path / "vcb"))
    with open(paths[0], "r+b") as f:
        f.truncate(64)
    kw = dict(batch_size=1, bucket_len=8, image_shape=(16, 16, 3),
              shuffle=False)
    pipe = native.NativePipeline(paths, **kw)
    with pytest.raises(RuntimeError, match="skipped 1 corrupt"):
        for _ in pipe.epoch(0):
            pass
    assert pipe.skipped_rows() == 1
    allowed = native.NativePipeline(paths, max_skipped_rows=1, **kw)
    batches = list(allowed.epoch(0))
    assert len(batches) == len(paths) and allowed.skipped_rows() == 1
    assert (batches[0]["actions"] == -1).all()


def _converted(store_path, out, **kw):
    """A converted store under ``out/train``, as the CLI lays it out."""
    native.convert_store_to_vcb(store_path, os.path.join(out, "train"), **kw)
    return argparse.Namespace(dataset_path=store_path, vcb_dir=out,
                              batch_size=2, buckets=[8], multiview_dir=None)


@pytest.mark.parametrize("stored,asked,match", [
    ({}, {"view_ids": VIEWS}, "needs 2"),
    ({}, {"gencad": True}, "not the preprocessed GenCAD"),
    ({"gencad": True}, {}, "GenCAD-converted"),
])
def test_stale_store_is_refused(store, tmp_path, stored, asked, match):
    _, path = store
    args = _converted(path, str(tmp_path / "vcb"), **stored)
    with pytest.raises(ValueError, match=f"{match}.*re-convert"):
        port_cli._build_native_pipelines(
            args, {"train": None}, view_ids=asked.get("view_ids", ()),
            gencad=asked.get("gencad", False))


def test_train_cli_runs_an_epoch_with_the_native_loader(store, tmp_path):
    root, path = store
    model_config = str(tmp_path / "model.json")
    with open(model_config, "w") as f:
        json.dump({"tiny": dict(TINY_CONFIG, image_size=16, vit_patch=8,
                                dropout=0.1, vit_attention_impl="fused",
                                ln_impl="pallas", dropout_impl="pallas",
                                train_config={"experiment_name": "native",
                                              "val_frequency": 1,
                                              "save_frequency": 1})}, f)
    vcb = str(tmp_path / "vcb")
    before = _native_tree()
    results = port_cli.main([
        "--device", "cpu", "--epochs", "1", "--native_loader",
        "--vcb_dir", vcb, "--dataset_path", path,
        "--config_path", os.path.join(path, "dataset_split.json"),
        "--model_config", model_config, "--model_name", "tiny",
        "--batch_size", "2", "--buckets", "8",
        "--checkpoint_dir", str(tmp_path / "ckpt"),
        "--log_dir", str(tmp_path / "logs"),
        "--class_weights", str(tmp_path / "none.json")])
    assert results["total_predictions"] > 0
    splits = json.load(open(os.path.join(path, "dataset_split.json")))
    for split in ("train", "val", "test"):
        assert len(native.scan_vcb(os.path.join(vcb, split))) == sum(
            1 for s in splits.values() if s == split)
    assert os.path.isdir(tmp_path / "ckpt" / "native" / "epoch_1")
    assert _native_tree() == before
    shutil.rmtree(vcb)
