"""Action vocabulary constants used by the serving path.

A copy of the constants of ``videocad_tpu/actions/vocab.py`` that decoding
needs, so the port imports no JAX package on the card. An action is a
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
