"""CLI: boot the simulation service behind the HTTP front-end.

    PYTHONPATH=src python -m repro_torch.serve --backend flowsim_fast --port 8642
    PYTHONPATH=src python -m repro_torch.serve --smoke
    PYTHONPATH=src python -m repro_torch.serve --smoke --device cpu

`flowsim_fast` and `m4` run on the card unless `--device cpu` is given;
without a card they raise. Default mode serves until SIGINT/SIGTERM,
then drains in-flight batches and exits. `--smoke` is the self-test: an
ephemeral-port boot, a mixed hit/miss workload driven through real HTTP
from concurrent client threads (16 unique scenarios in 2 shape buckets,
each submitted twice), metrics sanity assertions (hits >= 1, p99 queue
delay finite, nothing failed), and a clean drain — exit 0 iff all hold.

`--backend m4` serves the benchmark's model: the finished checkpoint in
`--ckpt-dir` (default results/m4_ckpt, the JAX package's format, which
`python -m repro.train`, the JAX benchmarks and `python -m
repro_torch.train` all write), at the benchmark's width. Where none is
there it trains one first with `train_suite`, on the benchmark's corpus
and training settings (the port's copy of `benchmarks/common.py`'s
`BENCH_M4`, `BENCH_TC` and `train_suite_spec`), with one dataset worker.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import tempfile
import threading

# benchmarks/common.py: BENCH_M4's widths, the corpus of train_suite_spec
# (N_TRAIN_SIMS sims of FLOWS_PER_SIM flows of table2_train_space,
# synthetic) and BENCH_TC, copied so that the port imports nothing of it
BENCH_M4 = dict(hidden=96, gnn_dim=64, mlp_hidden=64, snap_flows=16,
                snap_links=48)
N_TRAIN_SIMS = 12
FLOWS_PER_SIM = 150
BENCH_TC = dict(epochs=10, lr=1e-3, schedule="const", step_mode="per_sim",
                shuffle=False)


def train_suite_spec(n: int = N_TRAIN_SIMS):
    """The benchmark training corpus (`benchmarks.common.train_suite_spec`)."""
    from ..scenarios import get_suite
    return get_suite("table2_train_space", n=n, num_flows=FLOWS_PER_SIM,
                     synthetic=True)


def trained_m4(ckpt_dir: str, data_dir: str, device, log=print):
    """The benchmark model from `ckpt_dir`, trained there first when no
    finished checkpoint is found. Returns (params, cfg)."""
    from ..core.model import M4Config
    from ..train import TrainConfig, load_state, train_suite
    cfg = M4Config(**BENCH_M4)
    tc = TrainConfig(**BENCH_TC)
    state, done = load_state(ckpt_dir, cfg, device=device)
    if state is not None and done >= tc.epochs:
        log(f"[serve] m4 weights {state.weights_hash()[:12]} from "
            f"{ckpt_dir} (epoch {done})")
        return state.params, cfg
    log(f"[serve] no finished m4 checkpoint in {ckpt_dir}: training the "
        "benchmark model")
    state, _ = train_suite(train_suite_spec(), cfg,
                           dataclasses.replace(tc, ckpt_dir=ckpt_dir),
                           data_root=data_dir, workers=1, device=device,
                           log=log)
    return state.params, cfg


def _build_backend(name: str, args, log=print):
    from ..sim import get_backend
    if name in ("packet", "flowsim"):
        return get_backend(name)
    if name != "m4":
        return get_backend(name, device=args.device)
    params, cfg = trained_m4(args.ckpt_dir, args.data_dir, args.device,
                             log=log)
    return get_backend("m4", params=params, cfg=cfg, device=args.device)


def _build_service(args, log=print):
    from .service import ServeConfig, SimService
    backends = {name: _build_backend(name, args, log=log)
                for name in args.backend.split(",")}
    config = ServeConfig(flush_interval_s=args.flush_ms / 1e3,
                         batch_size=args.batch_size,
                         max_queue=args.max_queue,
                         default_timeout_s=args.timeout or None)
    return SimService(backends, config=config,
                      cache_dir=args.cache_dir or None)


def smoke(args, log=print) -> int:
    """Boot on an ephemeral port, drive the mixed workload, assert."""
    from .http import ServeClient, start_http_server

    args.cache_dir = args.cache_dir or tempfile.mkdtemp(prefix="serve_smoke_")
    service = _build_service(args, log=log)
    server = start_http_server(service, host=args.host, port=0)
    port = server.server_address[1]
    client = ServeClient(f"http://{args.host}:{port}")
    log(f"[serve --smoke] listening on {args.host}:{port}, "
        f"cache at {args.cache_dir}")

    # 16 unique scenarios in 2 shape buckets; two passes so the second is
    # pure cache hits. Each pass fans across real HTTP client threads.
    specs = [{"topo": "ft-4x2x2", "num_flows": 10 + 4 * (i % 2),
              "max_load": 0.4, "seed": i} for i in range(16)]
    backend = args.backend.split(",")[0]
    errors: list = []

    def drive(spec):
        try:
            reply = client.simulate(spec, backend=backend)
            if len(reply["fcts"]) != spec["num_flows"]:
                errors.append(f"bad fct count for seed {spec['seed']}")
        except Exception as exc:            # collected, asserted below
            errors.append(f"seed {spec['seed']}: {exc}")

    for phase in ("cold", "warm"):
        threads = [threading.Thread(target=drive, args=(s,)) for s in specs]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        log(f"[serve --smoke] {phase} pass done")

    metrics = client.metrics()
    prom_error = ""
    try:
        from ..obs.export import lookup, parse_prometheus
        parsed = parse_prometheus(client.metrics_prometheus())
        prom_total = lookup(parsed, "repro_serve_completed_total")
        if prom_total is None or int(prom_total) != metrics["completed"]:
            prom_error = (f"completed mismatch: prometheus={prom_total} "
                          f"json={metrics['completed']}")
        if lookup(parsed, "repro_serve_queue_depth",
                  lane=backend) is None:
            prom_error = prom_error or "missing per-lane queue_depth gauge"
    except Exception as exc:
        prom_error = f"{type(exc).__name__}: {exc}"
    server.shutdown()
    server.server_close()
    service.close()
    log("[serve --smoke] metrics: "
        + json.dumps({k: v for k, v in metrics.items()
                      if k not in ("lanes", "obs")},
                     indent=1, sort_keys=True))

    checks = {
        "no client errors": not errors,
        "all requests completed":
            metrics["completed"] == 2 * len(specs),
        "nothing failed/rejected/timed out":
            metrics["failed"] == metrics["rejected"]
            == metrics["timed_out"] == 0,
        "cache hits >= 1 (warm pass)": metrics["cache_hits"] >= 1,
        "p99 queue delay finite":
            math.isfinite(metrics["queue_delay_p99_ms"]),
        "batches flushed": metrics["batches"] >= 1,
        "prometheus /metrics round-trips": not prom_error,
    }
    if prom_error:
        log(f"[serve --smoke] prometheus error: {prom_error}")
    failed = [name for name, ok in checks.items() if not ok]
    for e in errors[:8]:
        log(f"[serve --smoke] client error: {e}")
    for name in checks:
        log(f"[serve --smoke] {'ok  ' if name not in failed else 'FAIL'} "
            f"{name}")
    return 1 if failed else 0


def serve_forever(args, log=print) -> int:
    import signal

    from .http import start_http_server

    service = _build_service(args, log=log)
    server = start_http_server(service, host=args.host, port=args.port,
                               verbose=args.verbose)
    host, port = server.server_address[:2]
    log(f"[serve] {args.backend} on http://{host}:{port} "
        f"(batch={args.batch_size}, flush={args.flush_ms}ms, "
        f"queue<={args.max_queue}, cache={args.cache_dir or 'off'}, "
        f"device={args.device})")

    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    stop.wait()
    log("[serve] draining in-flight batches ...")
    server.shutdown()
    server.server_close()
    service.close(drain=True)
    log("[serve] metrics at exit: "
        + json.dumps({k: v for k, v in service.metrics().items()
                      if k not in ("lanes", "obs")}, sort_keys=True))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.serve",
        description="Always-on simulation service of the port.")
    ap.add_argument("--backend", default="flowsim_fast",
                    help="comma-separated backend lanes "
                         "(default: flowsim_fast)")
    ap.add_argument("--device", default="cuda",
                    help="device of flowsim_fast and m4 (default cuda; "
                         "cpu runs the kernels' plain versions)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8642)
    ap.add_argument("--batch-size", type=int, default=8,
                    help="bucket capacity = padded batch size (default 8)")
    ap.add_argument("--flush-ms", type=float, default=50.0,
                    help="deadline flush interval in ms (default 50)")
    ap.add_argument("--max-queue", type=int, default=64,
                    help="pending-request bound per backend lane")
    ap.add_argument("--timeout", type=float, default=0.0,
                    help="default per-request queue deadline in seconds "
                         "(0 = none)")
    ap.add_argument("--cache-dir", default="",
                    help="content-hash result cache directory (off unless "
                         "set; --smoke uses a temp dir)")
    ap.add_argument("--ckpt-dir", default="results/m4_ckpt",
                    help="m4: checkpoint directory (default "
                         "results/m4_ckpt; trained there when missing)")
    ap.add_argument("--data-dir", default="results/train_data",
                    help="m4: dataset store used when training "
                         "(default results/train_data)")
    ap.add_argument("--smoke", action="store_true",
                    help="self-test: ephemeral port, mixed hit/miss HTTP "
                         "workload, metrics assertions")
    ap.add_argument("--verbose", action="store_true",
                    help="log every HTTP request")
    args = ap.parse_args(argv)
    if args.smoke:
        return smoke(args)
    return serve_forever(args)


if __name__ == "__main__":
    sys.exit(main())
