"""repro_torch.train — bucketed, resumable training of m4 on one device.

The port of `repro.train`: a content-hash dataset store of packet-DES
ground truth (`build_dataset`), shape buckets (`make_buckets`), and a
checkpoint/auto-resume training loop with LR schedules, per-epoch history
and held-out evaluation (`fit`, `evaluate_m4`):

    from repro_torch.sim import SimRequest
    from repro_torch.train import TrainConfig, build_dataset, evaluate_m4, fit

    reqs = [SimRequest.from_scenario(sample_scenario(s, num_flows=200))
            for s in range(4)]
    batches, _ = build_dataset(reqs, cfg, "results/train_data")
    state, history = fit(batches, cfg, TrainConfig(epochs=2))   # on the card
    report = evaluate_m4(state.params, cfg, held_out)

Checkpoints are the JAX package's format, readable by either package.
`train_suite` and the CLI (`python -m repro.train`) wait for a port of
`repro.scenarios`.
"""
from .batching import Bucket, make_buckets, pad_event_batch, stack_bucket
from .data import (DatasetReport, DatasetStore, build_dataset, dataset_key,
                   dataset_key_from_shards, shard_key)
from .loop import (TrainConfig, TrainState, evaluate_m4, fit, init_state,
                   load_state, write_train_log)

__all__ = [
    "Bucket", "make_buckets", "pad_event_batch", "stack_bucket",
    "DatasetStore", "DatasetReport", "build_dataset", "dataset_key",
    "dataset_key_from_shards", "shard_key",
    "TrainConfig", "TrainState", "fit", "init_state", "load_state",
    "evaluate_m4", "write_train_log",
]
