from videocad_tpu_torch.data.collate import (  # noqa: F401
    DEFAULT_BUCKETS,
    bucket_length,
    collate,
    pad_to,
)
from videocad_tpu_torch.data.dataset import (  # noqa: F401
    ImageLoader,
    VideoCADDataset,
    load_split_ids,
    read_image,
    scan_dataset,
)
from videocad_tpu_torch.data.pipeline import (  # noqa: F401
    DataPipeline,
    ShardedSampler,
    device_prefetch,
)
from videocad_tpu_torch.data.synthetic import (  # noqa: F401
    random_action_sequence,
    synthetic_batch_feed,
    write_synthetic_dataset,
)
