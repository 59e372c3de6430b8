"""Build the package's CUDA kernels with ``nvcc`` and load them with ctypes.

Every ``csrc/*.cu`` file is compiled at first use, one ``nvcc`` process per
source, all started together, and linked into ONE shared library with a plain
C interface (no PyTorch headers, which would add minutes to a build):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC -c <source>
    nvcc -shared <objects>

The library is named after a hash of the sources and flags, so an edit to a
kernel rebuilds it, and lives in ``audio_diffusion_torch/_build/`` (listed in
``.gitignore``). Each C entry point launches on the stream it is given and
returns ``cudaGetLastError()``; :func:`check` turns a non-zero code into an
exception. Kernel attributes (shared memory above 48 KB, clusters of more
than 8 CTAs) are set once per card (CUDA keeps them per device), before the
first launch there (:meth:`KernelLibrary.on`), never inside a launch.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from functools import lru_cache
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# Entry point -> argtypes. Every pointer and the stream are c_void_p, or
# ctypes would pass them as 32-bit ints.
SIGNATURES = {
    # (none): sets the GroupNorm kernel's attributes; called once, at load
    "adt_group_norm_silu_init": (),
    # x, scale, bias, y, B*G, eps, vec, plan (a fused_groupnorm._CPlan), stream
    "adt_group_norm_silu": (_P, _P, _P, _P, _LL, _F, _I, _P, _P),
    # (none): sets the attention kernel's attributes; called once, at load
    "adt_mha_init": (),
    # args (attention._ARGS: q, k, v, o, B*heads, heads, the b/h/n strides, vec), plan (an attention._CPlan),
    # stream
    "adt_mha_fwd": (_P, _P, _P),
    # k (the stage boundary, 0-3), stream
    "adt_stage_mark_launch": (_I, _P),
    # (none): sets the convolution kernels' attributes; called once, at load
    "adt_bi_conv2d_init": (),
    # x, w, bias (or None), y, batch, h, w, padding, plan (a batch_invariant_conv2d._CPlan), stream
    "adt_bi_conv2d": (_P, _P, _P, _P, _LL, _I, _I, _I, _P, _P),
}
# Entry points called with the GIL held (through ctypes.PyDLL): they read an
# argument array that the wrapper fills in place before each call.
GIL_HELD = frozenset({"adt_mha_fwd"})


def _sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME to build the CUDA kernels")
    return path


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libadt_kernels_{h.hexdigest()[:16]}.so"


@lru_cache(maxsize=1)
def load() -> "KernelLibrary":
    """Build (if needed) and load the kernel library. Raises on any failure."""
    return KernelLibrary()


class KernelLibrary:
    """The loaded ``.so`` with typed entry points; ``build_seconds`` is 0.0
    when an up-to-date library was already on disk, and ``build_log`` holds
    nvcc's output (``-Xptxas -v``: registers, shared memory, spills)."""

    def __init__(self):
        path = library_path()
        self.build_seconds = 0.0
        self.build_log = ""
        if not path.exists():
            self.build_seconds, self.build_log = _compile(path)
        self.path = path
        self._lib = ctypes.CDLL(str(path))
        self._gil_lib = ctypes.PyDLL(str(path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(self._gil_lib if name in GIL_HELD else self._lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            setattr(self, name, fn)
        self.devices = set()  # the cards whose kernel attributes are set

    def on(self, device: int) -> "KernelLibrary":
        """The library, with the kernels' attributes set on card ``device``."""
        if device not in self.devices:
            import torch

            with torch.cuda.device(device):
                check(self.adt_group_norm_silu_init(), "adt_group_norm_silu_init")
                check(self.adt_mha_init(), "adt_mha_init")
                check(self.adt_bi_conv2d_init(), "adt_bi_conv2d_init")
            self.devices.add(device)
        return self


def _run(cmds: list) -> str:
    """Run the commands side by side; raise if any fails. Returns their output."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for cmd in cmds]
    outs = [proc.communicate()[0] for proc in procs]
    for cmd, proc, out in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
    return "".join(outs)


def _compile(path: Path):
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    nvcc, sources = _nvcc(), _sources()
    objects = [str(tmp.with_name(f"{tmp.name}.{src.stem}.o")) for src in sources]
    t0 = time.perf_counter()
    try:
        log = _run([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)] for src, obj in zip(sources, objects)])
        log += _run([[nvcc, "-shared", "-o", str(tmp), *objects]])
    finally:
        for obj in objects:
            Path(obj).unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    os.replace(tmp, path)  # atomic: a concurrent build never loads a partial file
    path.with_suffix(".log").write_text(log)
    return seconds, log


def check(code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {code}")
