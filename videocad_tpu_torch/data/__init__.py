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
from videocad_tpu_torch.data.synthetic import (  # noqa: F401
    random_action_sequence,
    synthetic_batch_feed,
    write_synthetic_dataset,
)

# The pipeline imports torch; it loads on first use, so the host-only
# class-weight and ETL commands that read the store run without it.
_PIPELINE = ("DataPipeline", "ShardedSampler", "device_prefetch")


def __getattr__(name):
    if name in _PIPELINE:
        from videocad_tpu_torch.data import pipeline
        return getattr(pipeline, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
