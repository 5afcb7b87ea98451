"""The port's log ETL (``videocad_tpu_torch/etl/``, ``cli/generate_dataset``,
``cli/compute_class_weights``) against the JAX package's on the same
inputs.

Everything here is integers, strings, bytes and float64 weights, so every
comparison is exact. The logs are made from a numpy seed in the reference's
line format and cover all seven action kinds, shift chords, unmapped keys,
typed values past the 999 bin, scroll runs, unfinished entries and a
missing scale header.
"""

import filecmp
import importlib.util
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from videocad_tpu.cli import generate_dataset as jax_cli
from videocad_tpu.data import dataset as jax_dataset
from videocad_tpu.etl import dataset_gen as jax_gen
from videocad_tpu.etl import handlers as jax_handlers
from videocad_tpu.etl import log_parser as jax_parser
from videocad_tpu_torch.cli import compute_class_weights as port_weights
from videocad_tpu_torch.cli import generate_dataset as port_cli
from videocad_tpu_torch.data.synthetic import write_synthetic_dataset
from videocad_tpu_torch.etl import dataset_gen as port_gen
from videocad_tpu_torch.etl import handlers as port_handlers
from videocad_tpu_torch.etl import log_parser as port_parser

REPO = Path(__file__).resolve().parents[1]
KEYS = ["a", "l", "c", "y", "tab", "space", "enter", "up", "down", "left",
        "right", "esc", "s", "e", "h", "p", "7", "f1", "ctrl", "z"]
ACTIONS = ["click", "press keys", "hotkey", "write text", "type", "scroll",
           "key up", "key down", "move to", "drag to"]


def _line(rng, ts, action, args, status="finished"):
    x, y = rng.integers(0, 4000, 2)
    rx, ry = rng.uniform(-0.2, 1.2, 2).round(int(rng.integers(1, 6)))
    quoted = ", ".join(f"'{a}'" for a in args)
    tail = f", {quoted}" if args else ""
    return (f"{ts} - INFO - {status} {action}. Absolute (Point(x={x}, "
            f"y={y})) Relative (({rx}, {ry})) Args (<obj at 0x{ts:x}>{tail})")


def _args(rng, action):
    if action in ("press keys", "hotkey"):
        kind = rng.integers(0, 5)
        if kind == 0:
            return []
        if kind == 1:
            return [str(rng.choice(KEYS))]
        if kind == 2:   # a chord (mapped or not)
            return ["shift", str(rng.choice(KEYS))]
        if kind == 3:   # a repeat count rides args[1]
            key = str(rng.choice(KEYS))
            return [key, str(rng.integers(2, 7)), key]
        return ["shift", "7"]                 # the end sentinel
    if action in ("write text", "type"):
        if rng.random() < 0.1:
            return []
        return [str(int(rng.integers(-2000, 2000))) if rng.random() < 0.5
                else str(round(float(rng.uniform(-5000, 5000)), 2))]
    if action == "scroll":
        return [] if rng.random() < 0.1 else [str(rng.integers(-5, 6))]
    if action in ("key up", "key down"):
        return [str(rng.choice(["shift", "a", "ctrl"]))]
    return [str(rng.choice(KEYS))] if rng.random() < 0.5 else []


def _random_log(rng, sentinel=True, scale=True, n=None):
    """One capture's text: a scale header (or none), ``n`` entries of every
    kind, some unfinished, scroll runs, the sentinel somewhere or none."""
    n = int(rng.integers(1, 40)) if n is None else n
    lines = [f"Scale: {rng.choice([1.0, 1.5, 2.0, 2.25])}"] if scale else []
    ts = int(rng.integers(0, 20))
    kinds = list(rng.choice(ACTIONS, n))
    for i in range(len(kinds) - 1):     # runs of scrolls to coalesce
        if kinds[i] == "scroll" and rng.random() < 0.6:
            kinds[i + 1] = "scroll"
    for action in kinds:
        ts += int(rng.integers(1, 9))
        status = ("finished" if rng.random() < 0.85
                  else str(rng.choice(["started", "failed"])))
        args = _args(rng, action)
        if not sentinel and args == ["shift", "7"]:
            args = ["shift", "s"]
        lines.append(_line(rng, ts, action, args, status))
    if sentinel:    # one finished sentinel at least, in the second half
        at = int(rng.integers(len(lines) // 2, len(lines))) + 1
        lines[at:at] = [_line(rng, ts + 1, "press keys", ["shift", "7"])]
    return "\n".join(lines)


def _outcome(fn, *args, **kw):
    """The value, or the exception's type name and message."""
    try:
        return ("ok", fn(*args, **kw))
    except Exception as e:  # the cases under test: both must raise alike
        return ("raised", type(e).__name__, str(e))


def _logs(seed, count):
    rng = np.random.default_rng(seed)
    return [_random_log(rng, sentinel=rng.random() < 0.8,
                        scale=rng.random() < 0.9) for _ in range(count)]


def test_fuzz_300_logs_parse_and_convert_like_the_jax_package():
    kinds = set()
    for text in _logs(0, 300):
        for line in text.splitlines():
            assert (port_parser.parse_log_line(line)
                    == jax_parser.parse_log_line(line))
        for filtered in (False, True):
            ours = _outcome(port_parser.process_logs, text, filtered)
            theirs = _outcome(jax_parser.process_logs, text, filtered)
            assert ours == theirs
        logs = jax_parser.process_logs(text)
        ours = _outcome(port_handlers.convert_logs_to_vectors, logs)
        assert ours == _outcome(jax_handlers.convert_logs_to_vectors, logs)
        actions = _outcome(port_gen.logs_to_actions, text)
        want = _outcome(jax_gen.logs_to_actions, text)
        if actions[0] == "ok":
            assert actions[1][0].dtype == want[1][0].dtype
            np.testing.assert_array_equal(actions[1][0], want[1][0])
            assert actions[1][1] == want[1][1]
        else:
            assert actions == want
        if ours[0] == "ok":
            kinds.update(v[0] for v in ours[1][0])
            assert [port_handlers.matches_any(log) for log in logs] == \
                [jax_handlers.matches_any(log) for log in logs]
        else:
            kinds.add(ours[1])
    # Every command, and the missing-scale refusal, came up.
    assert {0, 1, 2, 3, 4, "ValueError"} <= kinds


def test_malformed_lines_raise_the_same_errors():
    good = ("5 - INFO - finished click. Absolute (Point(x=1, y=2)) "
            "Relative ((0.1, 0.2)) Args (<obj at 0x1>)")
    bad = [good.replace("5 - INFO", "five - INFO"),
           good.replace("click.", "click").replace("0.1, 0.2", "1, 2"),
           good.replace("Absolute (Point(x=1, y=2))", "Absolute (1, 2)"),
           good.replace("Relative ((0.1, 0.2))", "Relative (0.1)"),
           good.replace("Args (<obj at 0x1>)", "Args ()"), ""]
    for line in bad:
        with pytest.raises(port_parser.LogFormatError) as ours:
            port_parser.parse_log_line(line)
        with pytest.raises(jax_parser.LogFormatError) as theirs:
            jax_parser.parse_log_line(line)
        assert str(ours.value) == str(theirs.value)
        assert isinstance(ours.value, ValueError)
    # A repeat count that is no integer; a typed value without a scale.
    for text in ["Scale: 1.0\n" + good.replace(
                     "finished click", "finished press keys").replace(
                     "<obj at 0x1>)", "<obj at 0x1>, 'a', 'b', 'c')"),
                 good + "\n" + good.replace(
                     "finished click", "finished type").replace(
                     "<obj at 0x1>)", "<obj at 0x1>, '3.5')")]:
        logs = port_parser.process_logs(text)
        ours = _outcome(port_handlers.convert_logs_to_vectors, logs)
        assert ours[0] == "raised" and ours[1] == "ValueError"
        assert ours == _outcome(jax_handlers.convert_logs_to_vectors, logs)


def test_sequence_helpers_equal_the_jax_package(tmp_path):
    rng = np.random.default_rng(1)
    for t in (1, 5, 17):
        actions = rng.integers(-1, 1000, (t, 7))
        if t > 1:
            actions[rng.integers(0, t), 3] = 950
        frames = rng.integers(0, 256, (t, 4, 4, 3), dtype=np.uint8)
        stamps = list(rng.integers(0, 99, t).astype(float))
        for ours, theirs in [
                (port_gen.truncate_at_sentinel(actions, frames),
                 jax_gen.truncate_at_sentinel(actions, frames)),
                (port_gen.assemble_sequence(frames, actions, stamps),
                 jax_gen.assemble_sequence(frames, actions, stamps))]:
            assert len(ours) == len(theirs)
            for a, b in zip(ours, theirs):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
    for file_id, ext, kind in [("abcd1234", "pkl", "data"), ("ab", "x", "")]:
        assert (os.path.relpath(port_gen.shard_path(
                    str(tmp_path / "p"), file_id, ext, kind), tmp_path / "p")
                == os.path.relpath(jax_gen.shard_path(
                    str(tmp_path / "j"), file_id, ext, kind), tmp_path / "j"))


def _same_tree(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and names
    for name in names:
        assert filecmp.cmp(os.path.join(a, name), os.path.join(b, name),
                           shallow=False), name
    return names


def test_directory_stages_write_byte_equal_files(tmp_path, capsys):
    """Both stages through both CLIs: the JSON, the pickles and the CSVs
    byte for byte, sequences without a sentinel skipped, outputs that
    exist kept."""
    logs = tmp_path / "mouse"
    logs.mkdir()
    rng = np.random.default_rng(2)
    for i in range(12):
        text = _random_log(rng, sentinel=i % 4 != 0, n=30)
        (logs / f"{i:04d}.log").write_text(text)
    written = {}
    for pkg, main in (("port", port_cli.main), ("jax", jax_cli.main)):
        assert main(["--stage", "logs_to_json", "--source_dir", str(logs),
                     "--target_dir", str(tmp_path / pkg / "json")]) == 0
        assert main(["--stage", "json_to_vectors", "--source_dir",
                     str(tmp_path / pkg / "json"), "--target_dir",
                     str(tmp_path / pkg / "vec")]) == 0
        assert main(["--stage", "logs_to_json", "--is_filtered",
                     "--source_dir", str(logs), "--target_dir",
                     str(tmp_path / pkg / "filtered")]) == 0
        written[pkg] = capsys.readouterr().out.replace(str(tmp_path / pkg),
                                                       "")
    assert written["port"] == written["jax"]
    names = {stage: _same_tree(tmp_path / "port" / stage,
                               tmp_path / "jax" / stage)
             for stage in ("json", "vec", "filtered")}
    stems = {n.split(".")[0] for n in names["vec"] if n.endswith(".pkl")}
    # A quarter of the captures carry no sentinel and are skipped.
    assert 0 < len(stems) < 12 and "0000" not in stems
    for name in sorted(stems):
        with open(tmp_path / "port" / "vec" / f"{name}.pkl", "rb") as f:
            actions, stamps = pickle.load(f)
        want = port_gen.truncate_at_sentinel(
            *port_gen.logs_to_actions((logs / f"{name}.log").read_text()))
        np.testing.assert_array_equal(actions, want[0])
        assert actions[-1, 3] == 950
    # A second pass writes nothing over existing outputs.
    assert port_gen.json_dir_to_vectors(str(tmp_path / "port" / "json"),
                                        str(tmp_path / "port" / "vec")) == []
    for main in (port_cli.main, jax_cli.main):
        with pytest.raises(SystemExit) as exit_info:
            main(["--stage", "json_to_vectors"])
        assert exit_info.value.code == 2


LOG_LINES = [
    "Scale: 2.0",
    "10 - INFO - finished move to. Absolute (Point(x=1, y=2)) "
    "Relative ((0.1, 0.2)) Args (<obj at 0x1>, 'l')",
    "14 - INFO - finished scroll. Absolute (Point(x=1, y=2)) "
    "Relative ((0.1, 0.2)) Args (<obj at 0x1>, '3')",
    "20 - INFO - finished click. Absolute (Point(x=1, y=2)) "
    "Relative ((0.1, 0.2)) Args (<obj at 0x1>)",
    "25 - INFO - finished type. Absolute (Point(x=1, y=2)) "
    "Relative ((0.3, 0.2)) Args (<obj at 0x1>, '1.25')",
    "30 - INFO - finished press keys. Absolute (Point(x=1, y=2)) "
    "Relative ((0.1, 0.2)) Args (<obj at 0x1>, 'shift', '7')",
    "33 - INFO - finished click. Absolute (Point(x=1, y=2)) "
    "Relative ((0.1, 0.2)) Args (<obj at 0x1>)",
]


def _raw_tree(root, cv2, ids=("12345", "12399", "20001")):
    (root / "mouse").mkdir(parents=True)
    (root / "videos").mkdir()
    for n, file_id in enumerate(ids):
        (root / "mouse" / f"{file_id}.log").write_text("\n".join(LOG_LINES))
        img_dir = root / "images" / file_id[:4]
        img_dir.mkdir(parents=True, exist_ok=True)
        cv2.imwrite(str(img_dir / f"{file_id}_0.png"),
                    np.full((40, 40, 3), 60 * n, np.uint8))
        writer = cv2.VideoWriter(str(root / "videos" / f"{file_id}.avi"),
                                 cv2.VideoWriter_fourcc(*"MJPG"), 30,
                                 (48, 48))
        assert writer.isOpened()
        for i in range(40):
            writer.write(np.full((48, 48, 3), (i * 6 + n) % 255, np.uint8))
        writer.release()
    split = root / "split.json"
    split.write_text(json.dumps({ids[0]: "train", ids[1]: "train",
                                 ids[2]: "test"}))
    return split


def test_generate_stage_byte_equal_store_and_vcb(tmp_path, capsys):
    cv2 = pytest.importorskip("cv2")
    raw = tmp_path / "raw"
    split = _raw_tree(raw, cv2)
    for pkg, main in (("port", port_cli.main), ("jax", jax_cli.main)):
        assert main(["--raw_dir", str(raw), "--out_dir",
                     str(tmp_path / pkg / "store"), "--resize", "32", "32",
                     "--vcb_dir", str(tmp_path / pkg / "vcb"),
                     "--split_json", str(split)]) == 0
    out = capsys.readouterr().out.replace(str(tmp_path / "port"), "X")
    assert "generate: processed 3 sequences" in out
    shards = []
    for dirpath, _dirs, names in os.walk(tmp_path / "port"):
        for name in names:
            rel = os.path.relpath(os.path.join(dirpath, name),
                                  tmp_path / "port")
            assert filecmp.cmp(tmp_path / "port" / rel,
                               tmp_path / "jax" / rel, shallow=False), rel
            shards.append(rel)
    assert sorted(s for s in shards if s.endswith(".vcb")) == [
        "vcb/test/2000/20001_data.vcb", "vcb/train/1234/12345_data.vcb",
        "vcb/train/1239/12399_data.vcb"]
    with open(tmp_path / "port" / "store" / "1234" / "12345_data.pkl",
              "rb") as f:
        data = pickle.load(f)
    # The zero row, the move-to, scroll, click, type and the sentinel; the
    # click after the sentinel is cut.
    assert data["actions"].shape == (6, 7) and data["frames"].shape == (
        6, 32, 32, 3)
    assert data["actions"][-1, 3] == 950


def test_generate_stage_refuses_without_opencv(tmp_path, monkeypatch):
    monkeypatch.setattr(port_gen, "HAVE_CV2", False)
    monkeypatch.setattr(jax_gen, "HAVE_CV2", False)
    for main in (port_cli.main, jax_cli.main):
        with pytest.raises(SystemExit) as exit_info:
            main(["--raw_dir", str(tmp_path), "--out_dir",
                  str(tmp_path / "out")])
        assert exit_info.value.code == 2
    with pytest.raises(RuntimeError, match="OpenCV is required"):
        port_gen.extract_frames("x.avi", [0])
    assert not (tmp_path / "out").exists()


def test_class_weights_equal_the_jax_tool(tmp_path, capsys):
    store = tmp_path / "store"
    write_synthetic_dataset(str(store), num_sequences=6, min_len=5,
                            max_len=30, image_size=8, seed=3)
    spec = importlib.util.spec_from_file_location(
        "jax_class_weights", REPO / "tools" / "compute_class_weights.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    want = tool.compute_weights(jax_dataset.VideoCADDataset(str(store)))
    out = tmp_path / "w.json"
    assert port_weights.main([str(store), str(out)]) == str(out)
    assert f"wrote {out}" in capsys.readouterr().out
    assert out.read_text() == json.dumps(want)
    got = json.loads(out.read_text())
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(np.float64(got[key]),
                                      np.float64(want[key]))
    assert abs(sum(got["Label"]) - 1.0) < 1e-12
    for key in got:
        if key != "Label" and any(got[key]):
            assert abs(np.mean(got[key]) - 1e-3) < 1e-15
    with pytest.raises(SystemExit):
        port_weights.main([])


def test_host_only_commands_import_no_torch():
    """The ETL, class-weight and QA commands run on a host without loading
    torch (the package's torch re-exports load on first use)."""
    code = ("import sys\n"
            "import videocad_tpu_torch.cli.generate_dataset\n"
            "import videocad_tpu_torch.cli.compute_class_weights\n"
            "import videocad_tpu_torch.cli.eval_qa\n"
            "import videocad_tpu_torch.cli.qa_analysis\n"
            "import videocad_tpu_torch.data.native\n"
            "assert 'torch' not in sys.modules\n"
            "from videocad_tpu_torch.actions import apply_action_mask\n"
            "from videocad_tpu_torch.data import DataPipeline\n"
            "assert 'torch' in sys.modules\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
