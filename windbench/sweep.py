"""The knee of an open-loop serving cell, found once on the card: the
cell's path at each offered rate in turn, in one process, one line each
with the latency quantiles, the median latency of the first and the last
third of the requests (a backlog that grows shows as the last above the
first), how late the client ran and the fields served per second.

    python3 -m windbench.sweep --workload serve.milestone9k.steady \
        --rates 20,30,40 --seconds 12 --seed 5

The benchmark's runs never run this; the rate it finds is written into the
cell's traffic file by hand.
"""

from __future__ import annotations

import argparse
import json

import torch

from windbench import drive_serve
from windbench import run as wb_run


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=12.0)
    p.add_argument("--seed", type=int, default=1)
    args = p.parse_args(argv)
    bench = json.loads((wb_run.ROOT / "BENCHMARK.json").read_text())
    for i, rate in enumerate(float(r) for r in args.rates.split(",")):
        ctx = wb_run.Context(bench, args.workload, args.seed + i,
                             args.seconds, False, torch.device("cuda", 0))
        ctx.traffic["rate"] = rate
        out = drive_serve.run(ctx)
        print(json.dumps({"workload": args.workload, **out["load"],
                          "failed": out["failed"],
                          "batches": out["counters"]["batches"],
                          "batched": out["counters"]["batched_samples"],
                          "padded": out["counters"]["padded_samples"]}),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
