from videocad_tpu_torch.data.synthetic import (  # noqa: F401
    random_action_sequence,
    synthetic_batch_feed,
)
