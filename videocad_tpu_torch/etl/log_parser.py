"""Mouse-log line parser.

Port of ``videocad_tpu/etl/log_parser.py`` (no framework). Parses one line
of a recorded UI interaction log into a structured dict ``{timestamp,
status, action, absolute, relative, args}`` (or ``{scale}`` for the scale
header line). Output is field-for-field that of the reference parser
(transform_dataset.py:257-344), so the same raw logs give the same dataset
in either package.
"""

from __future__ import annotations

import re
from typing import Optional

_SCALE_RE = re.compile(r"Scale:\s*([\d.]+)")
_TIMESTAMP_RE = re.compile(r"(\d+)\s+-\s+INFO")
_MESSAGE_RE = re.compile(r"- INFO - (.+?)\.")
_ABSOLUTE_RE = re.compile(r"Absolute \(Point\(x=(\d+), y=(\d+)\)\)")
_RELATIVE_RE = re.compile(r"Relative \(\((-?[\d\.]+), (-?[\d\.]+)\)\)")
_ARGS_RE = re.compile(r"Args \((.+)\)")


class LogFormatError(ValueError):
    """Raised when a log line does not match the expected format."""


def _search(regex: re.Pattern, line: str) -> re.Match:
    match = regex.search(line)
    if not match:
        raise LogFormatError(f"Invalid formatting found: {line}")
    return match


def parse_log_line(line: str) -> dict:
    """Parse a single log line.

    Returns ``{"scale": float}`` for the scale header, otherwise a dict with
    timestamp (float frame index), status, action, absolute {x,y} ints,
    relative {x,y} floats, and args (list of strings with object reprs
    dropped and quotes/brackets stripped).
    """
    line = line.strip()

    scale = _SCALE_RE.search(line)
    if scale:
        return {"scale": float(scale.group(1))}

    result: dict = {}
    result["timestamp"] = float(_search(_TIMESTAMP_RE, line).group(1))

    message = _MESSAGE_RE.search(line)
    if not message:
        raise LogFormatError(f"Invalid formatting found: {line}")
    words = message.group(1).strip().split(" ")
    result["status"] = words[0]
    result["action"] = " ".join(words[1:])

    abs_match = _search(_ABSOLUTE_RE, line)
    result["absolute"] = {"x": int(abs_match.group(1)), "y": int(abs_match.group(2))}

    rel_match = _search(_RELATIVE_RE, line)
    result["relative"] = {"x": float(rel_match.group(1)), "y": float(rel_match.group(2))}

    args_str = _search(_ARGS_RE, line).group(1)
    args = [a.strip() for a in args_str.split(",")]
    args = [a for a in args if not (a.startswith("<") and a.endswith(">"))]
    result["args"] = [a.strip("'\"[]") for a in args]
    return result


def process_logs(log_text: str, is_filtered: bool = False,
                 matcher: Optional[callable] = None) -> list:
    """Parse every line of a log file.

    With ``is_filtered=True``, keep only entries accepted by ``matcher``
    (defaults to the handler chain's `matches_any`).
    """
    if matcher is None:
        from videocad_tpu_torch.etl.handlers import matches_any
        matcher = matches_any
    logs = []
    for line in log_text.strip().splitlines():
        log = parse_log_line(line)
        if not is_filtered or matcher(log):
            logs.append(log)
    return logs
