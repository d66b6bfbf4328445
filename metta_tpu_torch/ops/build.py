"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into ``build/metta_tpu_torch/lib<name>-<hash>.so``
under the repository root; the hash of the source and flags names the
library, so an edited source is rebuilt and an unchanged one is reused.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "metta_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
]


def sources():
    """Names of every kernel source in ``csrc/``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    found = shutil.which("nvcc") or str(Path(cuda_home) / "bin" / "nvcc")
    if not Path(found).exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{h}.so"


def _command(name: str, out: Path):
    return [nvcc_path(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(out), str(CSRC / f"{name}.cu")]


def build(names=None, log=None):
    """Compile the named sources (default: all) that are not built yet, one
    ``nvcc`` per source, all started together. Returns {name: .so path}.
    ``log`` receives each compiler's output (register and spill counts)."""
    names = sources() if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    paths = {}
    for name in names:
        path = library_path(name)
        paths[name] = path
        if path.exists():
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            _command(name, tmp), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ), tmp)
    failed = []
    for name, (proc, tmp) in procs.items():
        output, _ = proc.communicate()
        if log is not None:
            log(f"[nvcc {name}] {output.strip()}")
        if proc.returncode != 0:
            failed.append(f"{name}: {output.strip()}")
            continue
        os.replace(tmp, paths[name])
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return paths


def load_library(name: str):
    """The ctypes handle of kernel library ``name``, built if needed."""
    return ctypes.CDLL(str(build([name])[name]))


def cuobjdump(name: str, *flags) -> str:
    """The output of ``cuobjdump <flags>`` (the toolkit's, beside ``nvcc``)
    on kernel library ``name``, built if needed: ``-sass`` for the machine
    code, ``-res-usage`` for each kernel's registers, stack and local memory."""
    tool = Path(nvcc_path()).with_name("cuobjdump")
    out = subprocess.run([str(tool), *flags, str(build([name])[name])], capture_output=True,
                         text=True, timeout=300)
    if out.returncode != 0:
        raise RuntimeError(f"cuobjdump {' '.join(flags)} {name} failed: {out.stderr.strip()}")
    return out.stdout


def check_tensor(name, x, dtype, shape, device):
    """Raise ValueError unless ``x`` is a contiguous ``dtype`` tensor of
    ``shape`` on the CUDA ``device`` (what a kernel wrapper hands its kernel)."""
    if x.device.type != "cuda" or x.device != device:
        raise ValueError(f"{name} must be a CUDA tensor on {device}, got {x.device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
