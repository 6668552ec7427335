"""Build and load the hand-written CUDA kernels (`csrc/*.cu`).

Each source has a plain C interface and is compiled by `nvcc` into its own
shared library for `sm_90a`, then loaded with `ctypes`: no PyTorch headers,
so a build takes seconds. Libraries go to `build/kernels/` at the root of the
checkout (listed in `.gitignore`), named by a hash of the source, the shared
headers (`csrc/*.cuh`) and the flags, so an edited source is rebuilt and an
unchanged one is reused. Nothing is built
when a module is imported: the first launch builds what it needs, and
`build_all()` builds every source in parallel, one `nvcc` each.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

# Per-source extra flags. The warps and the losses reproduce PyTorch's
# elementwise rounding, so multiply-add contraction is off there; the
# matrix-product kernels (head, correlation, the two weight-MLP kernels)
# accumulate with fused multiply-adds.
SOURCES = {
    "flow_loss": ["--fmad=false"],
    "shift_warp": ["--fmad=false"],
    "head_kernel": [],
    "track_loss": ["--fmad=false"],
    "warp_features": ["--fmad=false"],
    "correlation": [],
    "dense_warp": ["--fmad=false"],
    "weight_mlp": [],
    "corr_weights": [],
}

_BASE_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
]

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _target(name: str) -> tuple[Path, list[str]]:
    src = CSRC / f"{name}.cu"
    flags = _BASE_FLAGS + SOURCES[name]
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers + " ".join(flags).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so", flags


def _command(name: str, out: Path, flags: list[str]) -> list[str]:
    return [_nvcc(), *flags, "-o", str(out), str(CSRC / f"{name}.cu")]


def build_all(verbose: bool = False) -> dict[str, Path]:
    """Compile every kernel source that is not built yet, all in parallel."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    outs = {}
    for name in SOURCES:
        out, flags = _target(name)
        outs[name] = out
        if not out.exists():
            # A per-process temporary, renamed into place: processes that
            # build at the same time never load a half-written library.
            tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
            cmd = _command(name, tmp, flags)
            if verbose:
                cmd.insert(1, "-Xptxas=-v")
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ), tmp, out)
    errors = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, out)
        if verbose and log:
            print(f"[nvcc {name}]\n{log}", flush=True)
    if errors:
        raise RuntimeError("\n".join(errors))
    return outs


def load(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """The loaded library for `name`, building it first if needed.

    `signatures` maps each C entry point to its argument types; every entry
    returns a cudaError_t as int.
    """
    lib = _loaded.get(name)
    if lib is None:
        out, _ = _target(name)
        if not out.exists():
            build_all()
        lib = ctypes.CDLL(str(out))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _loaded[name] = lib
    return lib


def check(status: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status}")


def stream_ptr(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def require_cuda_tensors(what: str, **tensors) -> None:
    """Device, contiguity checks shared by the wrappers."""
    for name, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{what}: {name} must be a CUDA tensor")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
