from videocad_tpu_torch.train.metrics import (  # noqa: F401
    init_metrics,
    update_metrics,
)
from videocad_tpu_torch.train.objective import (  # noqa: F401
    REFERENCE_CMD_WEIGHTS,
    LossConfig,
    compute_loss_and_metrics,
)
from videocad_tpu_torch.train.state import (  # noqa: F401
    TrainState,
    clip_by_global_norm_,
    create_train_state,
    make_optimizer,
)
from videocad_tpu_torch.train.steps import (  # noqa: F401
    add_action_noise,
    make_eval_step,
    make_train_step,
    prepare_model_inputs,
)
