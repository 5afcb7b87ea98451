"""Small IO helpers (JSON, pickle, text): port of
``videocad_tpu/utils/io.py``."""

from __future__ import annotations

import json
import os
import pickle


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def save_json(data, path: str):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(data, f, indent=2)


def load_pickle(path: str):
    with open(path, "rb") as f:
        return pickle.load(f)


def save_pickle(data, path: str):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(data, f)


def open_file(path: str) -> str:
    with open(path) as f:
        return f.read()
