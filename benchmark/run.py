"""The benchmark of ``audio_diffusion_torch`` on NVIDIA H100 cards.

    python3 benchmark/run.py --workload latent-256.gen-b32 --seed 7 --seconds 30 --trace 0

Runs one cell of ``BENCHMARK.json`` in this process, on the card, and prints
one JSON line last on standard output: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace 1``
its per-layer ones), ``device`` and, traced, ``breakdown``; ``check`` last,
each compared number beside its limit, which also end standard error. A run
without a card, or with fewer than the cell asks for, prints no result and
exits 1; so does one that finds ``jax``, ``jaxlib``, ``flax`` or
``audio_diffusion_tpu`` loaded once the window has closed.

Every cache a run writes lies under ``benchmark/_cache`` in the checkout, at
fixed paths, and the kernels' library under ``audio_diffusion_torch/_build``:
only a checkout's first run builds.

A run still going after ``WATCHDOG_S`` seconds (the longer one where the
kernels' library is not built yet) prints every thread's Python stack on
standard error and exits 1, with no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import faulthandler  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WATCHDOG_S = (330, 1140)  # a run's limit is 360 s, a checkout's first run's (the kernels' build) 1200 s
CACHE = ROOT / "benchmark" / "_cache"
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = str(CACHE / sub)
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    built = any((ROOT / "audio_diffusion_torch" / "_build").glob("*.so"))
    faulthandler.dump_traceback_later(WATCHDOG_S[0] if built else WATCHDOG_S[1], exit=True)
    if args.seed < 0:
        print("--seed must be a non-negative integer", file=sys.stderr)
        return 2
    import torch

    from benchmark.core.cell import Cell, CellError, run

    cell = Cell(ROOT, args.workload)
    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 1
    torch.set_num_threads(4)
    try:
        line, notes = run(cell, args.seed, args.seconds, bool(args.trace), "cuda:0", T_START, chips)
    except CellError as e:
        print(f"no result: {e}", file=sys.stderr)
        return 1
    finally:
        faulthandler.cancel_dump_traceback_later()
    for note in notes:
        print(note, file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
