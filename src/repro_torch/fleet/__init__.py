"""repro_torch.fleet — fault-tolerant sweep orchestration.

The port of `repro.fleet`. Shards any `repro_torch.scenarios` suite (or
dataset build) across a pool of supervised spawn workers, with the blob
store as the only coordination spine: atomic lease files claim work,
results land in the content-addressed caches (so a relaunched fleet
resumes from whatever completed), and a supervisor handles
retry/backoff, poison quarantine, dead-worker reaping and straggler
deadlines. `repro_torch.fleet.chaos` injects deterministic fault plans,
so tests and `chip_smoke.py` can show a disturbed run converges to the
bitwise-same cache as a clean one. The coordination directory's files
are the JAX package's: either package reads the other's.

    from repro_torch.fleet import FleetConfig

    runner = SweepRunner(backend, cache_dir="results/cache",
                         fleet=FleetConfig(workers=4))
    report = runner.run(get_suite("smoke16"))       # fleet-sharded

On the card, each worker is a process with its own CUDA context; the
contexts time-slice one card. CLI:
`python -m repro_torch.fleet --suite smoke16 [--chaos "kill:worker=0,after=2"]`.
"""
from .chaos import ChaosMonkey, Fault, FaultPlan, parse_plan
from .coord import Coordinator
from .jobs import (DatasetJob, FleetJob, SweepJob, dataset_tasks,
                   sweep_job_for, sweep_tasks)
from .metrics import FleetMetrics
from .supervisor import (FleetConfig, default_coord_dir, run_fleet,
                         task_set_digest)
from .worker import worker_entry

__all__ = [
    "ChaosMonkey", "Fault", "FaultPlan", "parse_plan",
    "Coordinator",
    "DatasetJob", "FleetJob", "SweepJob",
    "dataset_tasks", "sweep_job_for", "sweep_tasks",
    "FleetMetrics",
    "FleetConfig", "default_coord_dir", "run_fleet", "task_set_digest",
    "worker_entry",
]
