"""repro_torch.scenarios — declarative scenario suites + the sweep engine.

The port of `repro.scenarios`: define *what* to simulate as data
(`ScenarioSpec`, `Sweep.grid` / `Sweep.random`, named suites that build
the same specs as the JAX package's), and let `SweepRunner` decide *how*
— shape-compatible chunks of `Backend.run_many` batches on the backend's
device, and a content-hash-keyed on-disk result cache so overlapping
sweeps never re-simulate a scenario:

    from repro_torch.sim import get_backend
    from repro_torch.scenarios import SweepRunner, get_suite

    runner = SweepRunner(get_backend("flowsim_fast"),      # on the card
                         cache_dir="results/sweep_cache", chunk_size=8)
    report = runner.run(get_suite("smoke16"))
    print(report.table())

CLI: `python -m repro_torch.scenarios <suite>` (see `--list`).
"""
from .cache import ResultCache, result_key, result_key_raw
from .runner import SweepEntry, SweepReport, SweepRunner
from .spec import (ScenarioSpec, Sweep, random_spec, spec_from_dict,
                   spec_to_dict)
from .suites import SUITES, get_suite, list_suites, register_suite

__all__ = [
    "ScenarioSpec", "Sweep", "random_spec", "spec_to_dict", "spec_from_dict",
    "SweepRunner", "SweepReport", "SweepEntry",
    "ResultCache", "result_key", "result_key_raw",
    "SUITES", "get_suite", "list_suites", "register_suite",
]
