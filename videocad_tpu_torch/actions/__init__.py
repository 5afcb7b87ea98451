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
from videocad_tpu_torch.actions.ops import (  # noqa: F401
    apply_action_mask,
    normalize_actions,
    param_validity_mask,
)
