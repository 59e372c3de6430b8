"""A configuration of a new kind of model is new files only: a copy of the harness, given a toy text-to-spectrogram
family with classifier-free guidance (``additive/``: its family, configuration, traffic and limits) and one
appended workload, runs the new cell through ``core/cell.py::run`` on the CPU and comes out correct; with the
guidance left out of the toy program it comes out not correct; and no file the copy had before is changed."""

import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
ADDED = Path(__file__).resolve().parent / "additive"
SEED = 2**31 + 3
WORKLOAD = {"name": "toy-guided.toy-b2", "config": "toy-guided", "traffic": "toy-b2", "chips": 1,
            "why": "a toy guided text-to-spectrogram UNet: a text tower once per request, 2B UNet rows per step"}
CONFIG = {"name": "toy-guided", "source": "https://arxiv.org/abs/2207.12598",
          "file": "benchmark/configs/toy-guided.json", "reduced": [],
          "why": "a new family: text tower and classifier-free guidance, as new files only"}
RUN = """
import json, sys
from pathlib import Path
import torch
torch.set_num_threads(2)
from benchmark.core import cell as C, named
assert Path(named.__file__).resolve().is_relative_to(Path.cwd().resolve()), named.__file__
if sys.argv[1] == "unguided":
    fam = named.load("families", "toy_guided")
    program = fam.program
    fam.program = lambda cfg, seed, device: program(dict(cfg, guidance_scale=1.0), seed, device)
line, notes = C.run(C.Cell(Path("."), "toy-guided.toy-b2"), int(sys.argv[2]), 0.3, False, "cpu", 0.0)
print(json.dumps(line))
"""


def _digests(base: Path) -> dict:
    return {p.relative_to(base): hashlib.sha256(p.read_bytes()).hexdigest() for p in sorted(base.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts and "_cache" not in p.parts}


def harness_with_the_toy(tmp: Path) -> dict:
    """A copy of ``BENCHMARK.json`` and ``benchmark/`` in ``tmp`` with the toy's files added and its workload
    appended; returns the digests of the copy's files before the additions."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp)
    shutil.copytree(ROOT / "benchmark", tmp / "benchmark", ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    before = _digests(tmp / "benchmark")
    for path in ADDED.rglob("*"):
        if path.is_file() and "__pycache__" not in path.parts:
            target = tmp / "benchmark" / path.relative_to(ADDED)
            assert not target.exists(), target
            shutil.copy(path, target)
    manifest = json.loads((tmp / "BENCHMARK.json").read_text())
    manifest["configs"].append(CONFIG)
    manifest["workloads"].append(WORKLOAD)
    (tmp / "BENCHMARK.json").write_text(json.dumps(manifest, indent=1))
    return before


def run_toy(tmp: Path, kind: str, seed: int) -> dict:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run([sys.executable, "-c", RUN, kind, str(seed)], cwd=tmp, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_new_family_is_new_files_only(tmp_path):
    before = harness_with_the_toy(tmp_path)
    assert before == _digests(ROOT / "benchmark")  # the copy is whole
    guided = run_toy(tmp_path, "guided", SEED)
    assert guided["correct"], guided["check"]
    assert guided["attempted"] >= 1 and set(guided["metrics"]) == {"setup_s"}
    unguided = run_toy(tmp_path, "unguided", SEED)
    assert not unguided["correct"], unguided["check"]
    after = _digests(tmp_path / "benchmark")
    assert {k: after.get(k) for k in before} == before  # no file the copy had was changed
    manifest = json.loads((tmp_path / "BENCHMARK.json").read_text())
    original = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert manifest == dict(original, configs=original["configs"] + [CONFIG],
                            workloads=original["workloads"] + [WORKLOAD])
