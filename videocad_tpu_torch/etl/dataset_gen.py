"""Offline dataset generation: (video, mouse log, CAD image) -> training shards.

Port of ``videocad_tpu/etl/dataset_gen.py`` (numpy only): host-side ETL,
re-designed from the reference generate_dataset.py / transform_dataset.py
batch converters. Video decode uses OpenCV where it is installed; it is
imported only by :func:`extract_frames`, and ``HAVE_CV2`` says whether it
can be.

Output layout is the reference's sharded store, which either package reads:
``<out>/<id[:4]>/<id>_data.pkl`` holding ``{"frames": uint8 [T,H,W,C],
"actions": [T,7], "timesteps": [T]}`` plus the target CAD PNG copied
alongside. :func:`shard_path` is the one copy of the layout in the port:
``data/native.py`` and ``data/synthetic.py`` import it.
"""

from __future__ import annotations

import importlib.util
import os
import pickle
import shutil

import numpy as np

from videocad_tpu_torch.actions.vocab import END_SENTINEL
from videocad_tpu_torch.etl.handlers import convert_logs_to_vectors
from videocad_tpu_torch.etl.log_parser import process_logs

HAVE_CV2 = importlib.util.find_spec("cv2") is not None


def shard_path(base: str, file_id: str, ext: str, file_type: str = "frames") -> str:
    """``<base>/<id[:4]>/<id>_<type>.<ext>`` sharded layout (reference utils.py:21-40)."""
    shard_dir = os.path.join(base, file_id[:4])
    os.makedirs(shard_dir, exist_ok=True)
    if file_type:
        return os.path.join(shard_dir, f"{file_id}_{file_type}.{ext}")
    return shard_dir


def truncate_at_sentinel(actions: np.ndarray, *arrays):
    """Truncate a sequence at the first end-of-sequence sentinel.

    The sentinel is ``actions[:, 3] == END_SENTINEL`` (the 'end' key code);
    the sentinel row itself is kept (reference generate_dataset.py:185-191).
    Returns (actions, *arrays) truncated consistently.
    """
    end_idx = np.where(actions[:, 3] == END_SENTINEL)[0]
    if len(end_idx) == 0:
        return (actions, *arrays)
    end = end_idx[0] + 1
    return (actions[:end], *(a[:end] for a in arrays))


def assemble_sequence(frames: np.ndarray, actions: np.ndarray, timestamps: list):
    """Prepend a zero action + duplicated first frame, then truncate at the
    sentinel (reference generate_dataset.py:180-191).

    The zero action is the rollout seed: frame t pairs with the action taken
    *after* observing it, so the first observation gets a null action.
    """
    frames = np.vstack([frames[:1], frames])
    actions = np.vstack([np.zeros((1, actions.shape[1])), actions])
    timesteps = np.array(list(timestamps[:1]) + list(timestamps))
    actions, frames, timesteps = truncate_at_sentinel(actions, frames, timesteps)
    assert len(frames) == len(actions), "frames/actions length mismatch"
    return frames, actions, timesteps


def extract_frames(video_path: str, timestamps, resize=None) -> np.ndarray:
    """Decode one frame per action timestamp (frame index = int(timestamp))."""
    if not HAVE_CV2:
        raise RuntimeError("OpenCV is required for video decode but is not installed")
    import cv2

    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        raise RuntimeError(f"Could not open video {video_path}")
    frames = []
    for ts in timestamps:
        cap.set(cv2.CAP_PROP_POS_FRAMES, int(ts))
        ok, frame = cap.read()
        if not ok:
            cap.release()
            raise RuntimeError(f"Could not read frame {int(ts)} of {video_path}")
        if resize is not None:
            frame = cv2.resize(frame, resize, interpolation=cv2.INTER_LINEAR)
        frames.append(frame)
    cap.release()
    return np.array(frames)


def logs_to_actions(log_text: str):
    """Raw log text -> (actions [N,7] int array, timestamps list)."""
    logs = process_logs(log_text, is_filtered=False)
    vectors, timestamps = convert_logs_to_vectors(logs)
    return np.array(vectors), timestamps


def convert_log_dir_to_json(source_dir: str, target_dir: str,
                            is_filtered: bool = False) -> list:
    """Directory-level raw-log -> parsed-JSON conversion
    (reference transform_dataset.py:346-354)."""
    import json
    os.makedirs(target_dir, exist_ok=True)
    written = []
    for name in sorted(os.listdir(source_dir)):
        with open(os.path.join(source_dir, name)) as f:
            logs = process_logs(f.read(), is_filtered)
        out = os.path.join(target_dir, f"{os.path.splitext(name)[0]}.json")
        with open(out, "w") as f:
            json.dump(logs, f, indent=2)
        written.append(out)
    return written


def json_dir_to_vectors(source_dir: str, target_dir: str) -> list:
    """Directory-level parsed-JSON -> (actions, timesteps) pickles + CSVs,
    truncated at the end sentinel (reference transform_dataset.py:357-383).

    Matching the reference, sequences with NO sentinel are skipped entirely.
    """
    import json

    os.makedirs(target_dir, exist_ok=True)
    written = []
    for name in sorted(os.listdir(source_dir)):
        stem = os.path.splitext(name)[0]
        out_pkl = os.path.join(target_dir, f"{stem}.pkl")
        if os.path.exists(out_pkl):
            continue
        with open(os.path.join(source_dir, name)) as f:
            logs = json.load(f)
        vectors, timestamps = convert_logs_to_vectors(logs)
        actions = np.array(vectors)
        timesteps = np.array(timestamps)
        if actions.size == 0:
            continue
        end_idx = np.where(actions[:, 3] == END_SENTINEL)[0]
        if len(end_idx) == 0:
            continue
        end = end_idx[0] + 1
        actions, timesteps = actions[:end], timesteps[:end]
        np.savetxt(os.path.join(target_dir, f"{stem}.csv"), actions,
                   delimiter=",", fmt="%s")
        np.savetxt(os.path.join(target_dir, f"{stem}_t.csv"), timesteps,
                   delimiter=",", fmt="%s")
        with open(out_pkl, "wb") as f:
            pickle.dump((actions, timesteps), f)
        written.append(out_pkl)
    return written


def generate_dataset(raw_dir: str, out_dir: str, resize=(224, 224)) -> list:
    """Process every (video, log, image) triple under ``raw_dir``.

    Expects ``raw_dir/{videos,mouse,images}``; writes
    ``out_dir/<id[:4]>/<id>_data.pkl`` + the CAD PNG. Returns processed ids.
    """
    video_dir = os.path.join(raw_dir, "videos")
    log_dir = os.path.join(raw_dir, "mouse")
    image_dir = os.path.join(raw_dir, "images")
    done = []
    for video_file in sorted(os.listdir(video_dir)):
        file_id = os.path.splitext(video_file)[0]
        log_path = os.path.join(log_dir, f"{file_id}.log")
        image_path = os.path.join(image_dir, file_id[:4], f"{file_id}_0.png")
        if not (os.path.exists(log_path) and os.path.exists(image_path)):
            continue
        target = shard_path(out_dir, file_id, "pkl", "data")
        if os.path.exists(target):
            continue
        with open(log_path) as f:
            actions, timestamps = logs_to_actions(f.read())
        frames = extract_frames(os.path.join(video_dir, video_file), timestamps, resize)
        frames, actions, timesteps = assemble_sequence(frames, actions, timestamps)
        with open(target, "wb") as f:
            pickle.dump({"frames": frames, "actions": actions, "timesteps": timesteps}, f)
        shutil.copy(image_path, shard_path(out_dir, file_id, "png", "frame"))
        done.append(file_id)
    return done
