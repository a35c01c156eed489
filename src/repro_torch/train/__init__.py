"""repro_torch.train — bucketed, resumable training of m4 on one device.

The port of `repro.train`: a content-hash dataset store of packet-DES
ground truth over scenario specs (`build_dataset`), shape buckets
(`make_buckets`), a checkpoint/auto-resume training loop with LR
schedules, JAX's bucket order and per-epoch history (`fit`), held-out
evaluation (`evaluate_m4`), and the one-call pipeline (`train_suite`).
Each bucket shape trains through one compiled program (a CUDA graph of
the update on a card), counted in `TRACE_COUNTS` as JAX counts its
compiles:

    from repro_torch.scenarios import get_suite
    from repro_torch.train import TrainConfig, train_suite

    state, report = train_suite(
        get_suite("table2_train_space", n=4, num_flows=200), cfg,
        TrainConfig(epochs=2), data_root="results/train_data",
        eval_specs=list(get_suite("table3_empirical")))   # on the card

CLI: `python -m repro_torch.train` (the JAX package's flags, and
`--device`). Checkpoints are the JAX package's format, readable by either
package.
"""
from .batching import Bucket, make_buckets, pad_event_batch, stack_bucket
from .data import (DatasetReport, DatasetStore, build_dataset, dataset_key,
                   dataset_key_from_shards, shard_key)
from .loop import (TRACE_COUNTS, TrainConfig, TrainState, evaluate_m4, fit,
                   init_state, load_state, train_suite, write_train_log)

__all__ = [
    "Bucket", "make_buckets", "pad_event_batch", "stack_bucket",
    "DatasetStore", "DatasetReport", "build_dataset", "dataset_key",
    "dataset_key_from_shards", "shard_key",
    "TrainConfig", "TrainState", "TRACE_COUNTS", "fit", "init_state",
    "load_state", "evaluate_m4", "train_suite", "write_train_log",
]
