"""The action vocabulary, as VideoCAD publishes it: a 7-vector
``[cmd, x, y, key, times, scroll, typed]``, five commands, six parameters
in 1000 bins, -1 for an unused parameter."""

NUM_COMMANDS = 5
NUM_PARAMS = 6
NUM_BINS = 1000
ACT_DIM = 7
END_SENTINEL = 950
ACTION_PARAM_MASK = (
    (1, 1, 0, 0, 0, 0),   # move-to: x, y
    (0, 0, 1, 1, 0, 0),   # press-keys: key, times
    (0, 0, 0, 0, 1, 0),   # scroll: amount
    (0, 0, 0, 0, 0, 1),   # type: value
    (0, 0, 0, 0, 0, 0),   # click
)
KEY3_WINDOW = (200, 250)  # "times" is valid only for keys in [200, 250)
PARAM_TO_LABEL = (0, 0, 1, 1, 2, 3)
TOLERANCE = 3
PARAM_TOLERANCES = (TOLERANCE - 1, TOLERANCE - 1, 50, 200, 500,
                    TOLERANCE - 1)
# The published command-class weights (class_weights.json "Label").
CMD_WEIGHTS = (0.04332685213392362, 0.02915898563179938, 0.267566828114559,
               0.6005346809501417, 0.05941265316957628)
