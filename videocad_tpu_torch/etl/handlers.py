"""Log-entry -> 7-dim action-vector conversion.

Port of ``videocad_tpu/etl/handlers.py`` (no framework), a functional
re-design of the reference's chain-of-responsibility handlers
(transform_dataset.py:64-253): each handler is a (matches, process) pair
tried in a fixed priority order; the first match wins. The vectors equal
the JAX package's (``tests/test_torch_port_etl.py``).

A handler's ``process`` returns ``(vector, timestamp)`` or ``None`` to veto
the entry entirely (e.g. a press-keys log with an unmapped key).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

from videocad_tpu_torch.actions.vocab import (
    BIN,
    CMD_CLICK,
    CMD_MOVE_TO,
    CMD_PRESS_KEYS,
    CMD_SCROLL,
    CMD_TYPE,
    DEFAULT_VECTOR,
    KEY_MAP,
    MOVE_X_OFFSET,
    SCALE_FACTOR,
)

Vector = list
HandlerResult = Optional[Tuple[Vector, float]]


def _finished(log: dict) -> bool:
    return log.get("status", "") == "finished"


# --- matchers ---------------------------------------------------------------

def _is_click(log):
    return log.get("action", "").lower() == "click" and _finished(log)


def _is_press_keys(log):
    return log.get("action", "").lower() in ("press keys", "hotkey")


def _is_write_text(log):
    return log.get("action", "").lower() in ("write text", "type")


def _is_scroll(log):
    return log.get("action", "").lower() == "scroll" and _finished(log)


def _is_key_up(log):
    return log.get("action", "").lower() == "key up"


def _is_key_down(log):
    return log.get("action", "").lower() == "key down"


def _is_move_to(log):
    return log.get("action", "").lower() == "move to" and _finished(log)


# --- processors --------------------------------------------------------------

def _process_click(log) -> HandlerResult:
    vector = DEFAULT_VECTOR.copy()
    vector[0] = CMD_CLICK
    return vector, log["timestamp"]


def _process_press_keys(log) -> HandlerResult:
    vector = DEFAULT_VECTOR.copy()
    vector[0] = CMD_PRESS_KEYS
    args = log.get("args", [])
    if not args:
        return None
    for key, code in KEY_MAP.items():
        if isinstance(key, str):
            if key in args and "shift" not in args:
                vector[3] = code * BIN
        elif key[0] in args and key[1] in args:
            vector[3] = code * BIN
    if len(args) > 2:
        # Repeat count rides the args[1] slot: (n - 2) * 200.
        vector[4] = (int(args[1]) - 2) * 200
    if vector[3] == -1:
        return None  # unmapped key: drop the entry
    return vector, log["timestamp"]


def _process_write_text(log) -> HandlerResult:
    vector = DEFAULT_VECTOR.copy()
    vector[0] = CMD_TYPE
    args = log.get("args", [])
    if args:
        scale = log.get("scale", 0)
        if not scale:
            # The reference divides unguarded (transform_dataset.py:160-173,
            # ZeroDivisionError on a missing scale header); fail with the
            # offending entry named instead of a bare arithmetic error.
            raise ValueError(
                f"write_text log entry at t={log.get('timestamp')} has no "
                f"scale header; cannot bin typed value {args[0]!r}")
        # Typed value binned to [0, 999] around center 500.
        vector[6] = max(min(int(float(args[0]) / scale * 499) + 500, 999), 0)
    return vector, log["timestamp"]


def _process_scroll(log) -> HandlerResult:
    vector = DEFAULT_VECTOR.copy()
    vector[0] = CMD_SCROLL
    args = log.get("args", [])
    if not args:
        return None
    vector[5] = int(int(args[0]) > 0) * 500
    return vector, log["timestamp"]


def _process_key_up(log) -> HandlerResult:
    vector = DEFAULT_VECTOR.copy()
    vector[0] = CMD_PRESS_KEYS
    if "shift" in log.get("args", []):
        vector[3] = BIN * 17  # ('shift', 0) code — shift release
    return vector, log["timestamp"]


def _process_key_down(log) -> HandlerResult:
    vector = DEFAULT_VECTOR.copy()
    vector[0] = CMD_PRESS_KEYS
    if "shift" in log.get("args", []):
        vector[3] = BIN * 18  # ('shift', 1) code — shift press
    return vector, log["timestamp"]


def _process_move_to(log, has_next: bool = True) -> HandlerResult:
    vector = DEFAULT_VECTOR.copy()
    vector[0] = CMD_MOVE_TO
    # Reference quirk: coordinates are only filled when a following log entry
    # exists (transform_dataset.py:96-100) — a trailing move-to keeps -1 x/y.
    if has_next:
        rel = log.get("relative", {})
        vector[1] = round(rel.get("x", -1) * SCALE_FACTOR) + MOVE_X_OFFSET
        vector[2] = round(rel.get("y", -1) * SCALE_FACTOR)
    return vector, log["timestamp"]


# Priority order matches the reference registration order
# (transform_dataset.py:204-212).
HANDLERS: Tuple[Tuple[Callable, Callable], ...] = (
    (_is_click, _process_click),
    (_is_press_keys, _process_press_keys),
    (_is_write_text, _process_write_text),
    (_is_scroll, _process_scroll),
    (_is_key_up, _process_key_up),
    (_is_key_down, _process_key_down),
    (_is_move_to, _process_move_to),
)


def matches_any(log: dict) -> bool:
    """True when any handler accepts this (finished) log entry."""
    return _finished(log) and any(m(log) for m, _ in HANDLERS)


def convert_logs_to_vectors(logs: list) -> Tuple[list, list]:
    """Convert parsed log dicts to action vectors + timestamps.

    Semantics (matching transform_dataset.py:215-253):
      * the first entry carries the scale header and is skipped;
      * consecutive scroll actions are coalesced — only the timestamp of the
        last scroll in a run is kept;
      * a handler veto (None) drops the entry without trying later handlers.
    """
    vectors: list = []
    timestamps: list = []
    scale = logs[0].get("scale", 0) if logs else 0

    for i in range(1, len(logs)):
        log = dict(logs[i])
        log["scale"] = scale
        if not _finished(log):
            continue
        for matches, process in HANDLERS:
            if not matches(log):
                continue
            if process is _process_move_to:
                result = process(log, has_next=i + 1 < len(logs))
            else:
                result = process(log)
            if result is None:
                break  # vetoed
            vector, timestamp = result
            if vector[0] == CMD_SCROLL and vectors and vectors[-1][0] == CMD_SCROLL:
                timestamps[-1] = timestamp  # coalesce consecutive scrolls
            else:
                vectors.append(vector)
                timestamps.append(timestamp)
            break
    return vectors, timestamps
