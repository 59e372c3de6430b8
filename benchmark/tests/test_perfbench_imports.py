"""Nothing the benchmark loads is of the JAX package's world, compared by whole top-level names; the
reference and the counts import nothing of the program; the core and the counts know no model (only the families
import the models); a run without a card, or without the program, prints no result."""

import ast
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark.core import cell as C

ROOT = Path(__file__).resolve().parents[2]


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    for name in ("jaxtyping", "flaxen", "audio_diffusion_tpu_extra", "audio_diffusion_torch.x"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert C.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    monkeypatch.setitem(sys.modules, "audio_diffusion_tpu", sys)
    assert C.forbidden_modules() == ["audio_diffusion_tpu", "jax"]


def test_a_run_loads_nothing_forbidden():
    code = ("import json, sys\n"
            "from pathlib import Path\n"
            "import benchmark.run\n"
            "from benchmark.core import cell as C\n"
            "from benchmark.tests import tiny\n"
            "c = C.Cell(Path('.'), 'latent-256.serve-open', cfg=tiny.config('latent-256'),\n"
            "           mix=tiny.mix('serve-open', rate_per_s=8.0, max_batch=2, check_requests=2),\n"
            "           limits=tiny.LOOSE)\n"
            "C.run(c, 5, 0.5, True, 'cpu', 0.0)\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(__import__("json").loads(out.stdout.strip().splitlines()[-1]))
    assert "audio_diffusion_torch" in loaded and not loaded & set(C.FORBIDDEN)


@pytest.mark.parametrize("package", ["reference", "counts"])
def test_yardstick_imports_nothing_of_the_program(package):
    for path in (ROOT / "benchmark" / package).glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = [a.name for a in node.names] if isinstance(node, ast.Import) else (
                [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] not in ("audio_diffusion_torch", *C.FORBIDDEN), (path, name)


def _imported(path: Path, package=None) -> list:
    """Every module and imported name of ``path``'s imports, dotted, relative ones resolved inside its package
    (``package``: the package's parts, where ``path`` lies outside the repo)."""
    package = package or path.relative_to(ROOT).parent.parts
    out = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            base = (node.module or "").split(".") if not node.level else [
                *package[:len(package) - node.level + 1], *filter(None, (node.module or "").split("."))]
            out += [".".join(base)] + [".".join([*base, a.name]) for a in node.names]
    return out


@pytest.mark.parametrize("package", ["core", "counts"])
def test_core_and_counts_know_no_model(package):
    for path in (ROOT / "benchmark" / package).glob("*.py"):
        for name in _imported(path):
            assert name != "benchmark.reference.models" and not name.startswith("audio_diffusion_torch.models"), (
                path, name)


def test_the_import_scan_resolves_relative_imports(tmp_path):
    assert "benchmark.reference.models" in _imported(ROOT / "benchmark" / "families" / "audio_diffusion.py")
    probe = tmp_path / "probe.py"
    probe.write_text("from ..reference import models\nfrom ..reference.models import UNet\nfrom . import named\n")
    got = _imported(probe, ("benchmark", "core"))
    assert got.count("benchmark.reference.models") == 2 and "benchmark.core.named" in got


def _run(cwd):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload", "latent-256.gen-b32", "--seed",
                           str(2**31 + 1), "--seconds", "1", "--trace", "0"], cwd=cwd, capture_output=True,
                          text=True, timeout=300)


def test_no_card_or_no_program_no_result(tmp_path):
    import torch

    if not torch.cuda.is_available():
        out = _run(ROOT)
        assert out.returncode != 0 and out.stdout == ""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
