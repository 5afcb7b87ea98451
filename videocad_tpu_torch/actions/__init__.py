from videocad_tpu_torch.actions.vocab import (  # noqa: F401
    ACT_DIM,
    ACTION_PARAM_MASK,
    CMD_MOVE_TO,
    CMD_TYPE,
    END_SENTINEL,
    KEY3_WINDOW_HI,
    KEY3_WINDOW_LO,
    NUM_BINS,
    NUM_COMMANDS,
    NUM_PARAMS,
)

# The ops import torch; they load on first use, so the host-only log ETL
# that reads the vocabulary runs without it.
_OPS = ("apply_action_mask", "normalize_actions", "param_validity_mask")


def __getattr__(name):
    if name in _OPS:
        from videocad_tpu_torch.actions import ops
        return getattr(ops, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
