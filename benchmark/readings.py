"""The readings a cell's limits are set from, on the card at the cell's own size (not run by the benchmark's
own runs).

    python3 benchmark/readings.py --workload latent-256.gen-b32 --program 11,12,13 --control 21,22,23 \
        --seconds 4 --out readings.jsonl

- ``--program``: for each seed, a whole run of the cell (``core/cell.py::run``) with a short window; the
  numbers its check compared. Their largest is a limit's lower reading.
- ``--control``: for each seed, the control: the plain reference put in the program's place and computed
  in float8 e4m3 (the step below the configurations' bfloat16), judged by the same numbers on the rows a
  run would check (the mode's ``control_rows``). Its smallest is a limit's upper reading.
- ``--unet-control``: the same with the UNet alone in float8 and the VAE and the audio stage in float32:
  how much of the control's reading the UNet's layers carry.
- ``--attention-zero``: a fault planted in the float32 reference put in the program's place: every
  attention core returns zeros (in latent-256, the layer of ``flash_mha``). How far the check sees a
  fault confined to the attention layers.

One JSON line per reading, appended to ``--out`` and printed.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import benchmark.run  # noqa: E402,F401  (the run's cache directories and environment)


def attention_zero_rows(cell, seed: int, device) -> list:
    """The mode's control rows with the outputs of the float32 reference whose UNet's attention cores return
    zeros (its VAE's are kept): the family's ``reference_images`` variant "attention-zero"."""
    import torch

    from benchmark.core import named
    from benchmark.reference import pipeline as ref

    cfg, rows = cell.cfg, cell.mode().control_rows(cell, seed, device)
    with torch.no_grad(), ref.float32_exact():
        images = named.family(cfg).reference_images(cfg, seed, cell.mix["steps"], rows, device, "attention-zero")
        phase = torch.stack([r["gl_phase"] for r in rows]).to(device)
        pcm = torch.cat([ref.images_to_pcm16(images[i:i + 8], phase[i:i + 8], cfg["mel"])
                         for i in range(0, len(rows), 8)])
    return [dict(r, image=images[i].cpu().numpy(), audio=pcm[i].cpu().numpy()) for i, r in enumerate(rows)]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--program", default="", help="comma-separated seeds")
    p.add_argument("--control", default="", help="comma-separated seeds")
    p.add_argument("--unet-control", default="", help="comma-separated seeds")
    p.add_argument("--attention-zero", default="", help="comma-separated seeds")
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    import torch

    from benchmark.core import check
    from benchmark.core.cell import Cell, run

    cell = Cell(ROOT, args.workload)
    device = torch.device("cuda:0" if torch.cuda.is_available() else "cpu")

    def emit(rec):
        text = json.dumps(rec)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")

    for s in filter(None, args.program.split(",")):
        t = time.perf_counter()
        line, notes = run(cell, int(s), args.seconds, False, device, t)
        emit({"workload": cell.name, "kind": "program", "seed": int(s), "correct": line["correct"],
              "numbers": {k: v["value"] for k, v in line["check"].items()}, "metrics": line["metrics"],
              "notes": notes, "seconds": time.perf_counter() - t})
    for kind, precision, seeds in (("control_fp8", "fp8", args.control),
                                   ("unet_control_fp8", "fp8-unet", args.unet_control)):
        for s in filter(None, seeds.split(",")):
            t = time.perf_counter()
            rows = cell.mode().control_rows(cell, int(s), device)
            numbers = check.worst(check.judge_rows(cell.cfg, int(s), cell.mix["steps"], rows, device,
                                                   precision=precision))
            emit({"workload": cell.name, "kind": kind, "seed": int(s), "numbers": numbers,
                  "seconds": time.perf_counter() - t})
    for s in filter(None, args.attention_zero.split(",")):
        t = time.perf_counter()
        rows = attention_zero_rows(cell, int(s), device)
        numbers = check.worst(check.judge_rows(cell.cfg, int(s), cell.mix["steps"], rows, device))
        emit({"workload": cell.name, "kind": "fault_attention_zero", "seed": int(s), "numbers": numbers,
              "seconds": time.perf_counter() - t})


if __name__ == "__main__":
    main()
