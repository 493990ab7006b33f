"""CLI entry point for the GNN inference server (repro_torch.serve).

Counterpart of ``repro/launch/serve.py``.  Trains a mini-batch model on a
synthetic Table-1 dataset, warm-starts an
:class:`~repro_torch.serve.InferenceServer` over it (sharing the training
run's PlanCache, optionally through a persisted snapshot), drives a
short open-loop burst against it on the server's background thread, and
prints the latency/shedding/degradation report.  Everything runs on
``--device`` (the card by default):

  PYTHONPATH=src python -m repro_torch.launch.serve --device cuda \\
      --dataset cora --scale 0.2 --train-steps 20 --qps 200 --seconds 2 \\
      --deadline-ms 100 --plan-cache /tmp/plans.bin
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch import DEFAULT_DEVICE
from repro_torch.core import gnn
from repro_torch.graphs import graph as graph_mod
from repro_torch.obs import Telemetry
from repro_torch.serve import InferenceServer, ServeConfig
from repro_torch.train.gnn_steps import train_minibatch


def build_server(dataset: str = "cora", scale: float = 0.2,
                 train_steps: int = 20, seed: int = 0,
                 batch_nodes: int = 32, fanouts: tuple = (4, 2),
                 model: str = "gcn", serve_cfg: ServeConfig | None = None,
                 telemetry: Telemetry | None = None,
                 verbose: bool = False, *,
                 device: str | torch.device = DEFAULT_DEVICE
                 ) -> InferenceServer:
    """Train a small model on ``device`` and stand up a server over it
    there, sharing the training PlanCache (its committed plans carry
    over)."""
    g = graph_mod.synth_dataset(dataset, scale=scale, seed=seed)
    cfg = gnn.GNNConfig(model=model, sampler="neighbor",
                        batch_nodes=batch_nodes, fanouts=tuple(fanouts),
                        hidden=16, seed=seed)
    res = train_minibatch(g, cfg, steps=train_steps, verbose=verbose,
                          eval_batches=1, device=device)
    return InferenceServer(g, cfg, res.params, serve_cfg=serve_cfg,
                           plan_cache=res.plan_cache, telemetry=telemetry,
                           device=device)


def open_loop_burst(server: InferenceServer, qps: float, seconds: float,
                    deadline_s: float | None = None, seed: int = 0) -> list:
    """Open-loop load: submit at a fixed arrival rate regardless of
    completions (arrivals do not slow down when the server does — which
    is what makes overload visible instead of self-throttling).  Returns
    the futures; the server must be running (``server.start()``)."""
    rng = np.random.default_rng(seed)
    n = max(int(qps * seconds), 1)
    nodes = rng.integers(0, server.ego.graph.n, size=n)
    period = 1.0 / max(qps, 1e-9)
    futs = []
    t0 = time.monotonic()
    for i, node in enumerate(nodes):
        lag = t0 + i * period - time.monotonic()
        if lag > 0:
            time.sleep(lag)
        futs.append(server.submit(int(node), deadline_s))
    return futs


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dataset", default="cora")
    ap.add_argument("--scale", type=float, default=0.2)
    ap.add_argument("--train-steps", type=int, default=20)
    ap.add_argument("--model", default="gcn", choices=("gcn", "gin", "sage"))
    ap.add_argument("--batch-nodes", type=int, default=32)
    ap.add_argument("--fanouts", type=int, nargs="+", default=[4, 2])
    ap.add_argument("--qps", type=float, default=200.0)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--deadline-ms", type=float, default=100.0)
    ap.add_argument("--queue-limit", type=int, default=64)
    ap.add_argument("--max-batch", type=int, default=16)
    ap.add_argument("--plan-cache", default="",
                    help="PlanCache snapshot path: loaded before warmup, "
                         "saved after (cold-start mitigation)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", default="", help="write the report here")
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="where the model trains and serves: cuda (the "
                         "hand kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)

    scfg = ServeConfig(deadline_s=args.deadline_ms / 1e3,
                       queue_limit=args.queue_limit,
                       max_batch=args.max_batch,
                       plan_cache_path=args.plan_cache, seed=args.seed)
    server = build_server(args.dataset, scale=args.scale,
                          train_steps=args.train_steps, seed=args.seed,
                          batch_nodes=args.batch_nodes,
                          fanouts=tuple(args.fanouts), model=args.model,
                          serve_cfg=scfg, verbose=args.verbose,
                          device=args.device)
    warm = server.warmup(save=bool(args.plan_cache))
    print(f"warmup: loaded={warm['loaded']} new_traces={warm['new_traces']} "
          f"rungs={warm['rungs']}")
    with server:
        futs = open_loop_burst(server, args.qps, args.seconds,
                               seed=args.seed)
        for f in futs:
            f.result(timeout=scfg.deadline_s * 4 + 5)
    st = server.stats()
    lat = st["latency"]
    report = dict(
        device=str(server.device), qps_offered=args.qps,
        served=st["admitted"] - st["timeouts"] - st["errors"],
        shed=st["shed"], timeouts=st["timeouts"], errors=st["errors"],
        shed_pct=st["shed_pct"], rung=st["rung"],
        degrades=st["degrades"], n_traces=st["n_traces"],
        p50_ms=lat["p50"] * 1e3, p99_ms=lat["p99"] * 1e3)
    print(f"served {report['served']}/{len(futs)} on {report['device']} "
          f"(shed {st['shed']}, timeouts {st['timeouts']}, errors "
          f"{st['errors']}) p50 {report['p50_ms']:.1f}ms p99 "
          f"{report['p99_ms']:.1f}ms rung {st['rung']} traces "
          f"{st['n_traces']}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2)
    return report


if __name__ == "__main__":
    main()
