"""The rate sweep that fixed an open-loop cell's rate (not run by the benchmark's own runs).

    python3 benchmark/sweep.py --workload latent-256.serve-open --rates 8,12,16,20 --seconds 30 --seed 5

Builds the cell's batcher once, warms it, then runs the cell's open loop at each rate in turn, with the
mix's own parameters otherwise. A rate is sustained when nothing is shed, every request completes, and no
more than one largest tier is still queued as the window closes. The cell's rate is 0.8 x the highest
sustained rate. One JSON line per rate.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import benchmark.run  # noqa: E402,F401  (the run's cache directories and environment)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--seed", type=int, default=5)
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from audio_diffusion_torch.serving.batcher import DynamicBatcher
    from benchmark.core import drivers
    from benchmark.core.cell import Cell

    cell = Cell(ROOT, args.workload)
    mix = cell.mix
    pipe = cell.mode().served_family(cell.cfg).program(cell.cfg, args.seed, torch.device("cuda:0"))
    batcher = DynamicBatcher(pipe, max_batch=mix["max_batch"], max_wait_ms=mix["max_wait_ms"], steps=mix["steps"],
                             eta=mix["eta"], pcm16=mix["pcm16"], batch_policy=mix["batch_policy"])
    try:
        t = time.perf_counter()
        batcher.warmup()
        print(json.dumps({"warmup_s": time.perf_counter() - t}), flush=True)
        for rate in map(float, args.rates.split(",")):
            batches, served = batcher.batches_run, batcher.requests_served
            res = drivers.run_open(batcher, dict(mix, rate_per_s=rate), args.seed, args.seconds)
            n_batches = batcher.batches_run - batches
            sustained = (not any(res.shed) and res.completed == len(res.due)
                         and res.queued_at_close <= mix["max_batch"])
            print(json.dumps({"rate_per_s": rate, "requests": len(res.due), "completed": res.completed,
                              "shed": int(sum(res.shed)), "queued_at_close": res.queued_at_close,
                              "p50_latency_s": float(np.median(res.latency_s)),
                              "p95_latency_s": drivers.p95(res.latency_s),
                              "late_max_s": float(res.late_s.max()), "batches": n_batches,
                              "mean_batch": (batcher.requests_served - served) / max(n_batches, 1),
                              "sustained": sustained}), flush=True)
    finally:
        batcher.close()


if __name__ == "__main__":
    main()
