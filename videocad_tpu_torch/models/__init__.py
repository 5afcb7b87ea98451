from videocad_tpu_torch.models.videocadformer import (  # noqa: F401
    VideoCADFormer,
    VideoCADFormerConfig,
)
from videocad_tpu_torch.models.factory import (  # noqa: F401
    FLAGSHIP_NAME,
    create_model,
    example_inputs,
    flagship_config,
    init_params,
    load_named_config,
)
from videocad_tpu_torch.models.convert import (  # noqa: F401
    jax_tree_from_state_dict,
    load_jax_params,
    state_dict_from_jax,
)
