"""Action vocabulary constants used by the serving and training paths.

A copy of the constants of ``videocad_tpu/actions/vocab.py`` that decoding,
the objective and the synthetic data need, so the port imports no JAX
package on the card. An action is a
7-dim integer vector ``[cmd, x, y, key, times, scroll, typed]``: ``cmd`` in
[0, 4] and six parameters discretized to 1000 bins, ``-1`` marking an
unused parameter. ``tests/test_torch_port_ops.py`` holds these equal to
the originals.
"""

from __future__ import annotations

NUM_COMMANDS = 5
NUM_PARAMS = 6
NUM_BINS = 1000
ACT_DIM = 7  # cmd + 6 params
END_SENTINEL = 950  # on param index 3 (key)

# Command ids
CMD_MOVE_TO = 0
CMD_PRESS_KEYS = 1
CMD_SCROLL = 2
CMD_TYPE = 3
CMD_CLICK = 4

# Which params are valid for each command. Row = cmd, col = param index.
ACTION_PARAM_MASK = (
    (1, 1, 0, 0, 0, 0),  # move-to: x, y
    (0, 0, 1, 1, 0, 0),  # press-keys: key, times
    (0, 0, 0, 0, 1, 0),  # scroll: amount
    (0, 0, 0, 0, 0, 1),  # type: value
    (0, 0, 0, 0, 0, 0),  # click: none
)

# Param 3 ("times key pressed") is only meaningful when param 2 ("key")
# falls in [KEY3_WINDOW_LO, KEY3_WINDOW_HI).
KEY3_WINDOW_LO = 200
KEY3_WINDOW_HI = 250

# Parameter names, matching the keys of a class_weights.json.
PARAM_NAMES = (
    "Label", "x", "y", "Key Pressed", "Times Key Pressed",
    "Scroll Amount", "Typed Value",
)

# Param index -> command label whose class weight scales its loss.
PARAM_TO_LABEL = (0, 0, 1, 1, 2, 3)

# Accuracy tolerance per param, and whether its window is one-sided
# ("above": pred in [t, t + tol)) or two-sided (|pred - t| < TOLERANCE).
TOLERANCE = 3
PARAM_TOLERANCES = (TOLERANCE - 1, TOLERANCE - 1, 50, 200, 500, TOLERANCE - 1)
PARAM_ABOVE = (False, False, True, True, True, False)
