from videocad_tpu_torch.etl.log_parser import parse_log_line, process_logs  # noqa: F401
from videocad_tpu_torch.etl.handlers import convert_logs_to_vectors, matches_any  # noqa: F401
from videocad_tpu_torch.etl.dataset_gen import (  # noqa: F401
    assemble_sequence,
    generate_dataset,
    logs_to_actions,
    shard_path,
    truncate_at_sentinel,
)
