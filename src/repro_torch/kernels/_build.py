"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface and loaded with :mod:`ctypes`; no
PyTorch header is included, so a build takes seconds.  Libraries are built at
first use into ``build/repro_torch_kernels/`` (override the directory with
``REPRO_TORCH_BUILD_DIR``), keyed by a hash of every file under ``csrc/`` and
of the compiler flags, so an edited source never runs a stale binary.

``-fmad=false`` is part of the contract, not a tuning choice: the scheduler
kernels are held bit for bit against their plain PyTorch versions, and eager
PyTorch never contracts ``a * b + c`` into a fused multiply-add.  (The paged
attention kernel is held to a tolerance and would not need the flag.)
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["NVCC_FLAGS", "KERNEL_SOURCES", "build_all", "load", "build_dir",
           "check_launch"]

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

CSRC = Path(__file__).resolve().parent / "csrc"

#: library name -> translation unit under ``csrc/``
KERNEL_SOURCES = {"sched_step": "sched_step.cu",
                  "token_clock": "token_clock.cu",
                  "paged_kv_gather": "paged_kv_gather.cu"}

_LIBS: dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    # src/repro_torch/kernels/_build.py -> the checkout's root
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"


def _nvcc() -> str:
    for var in ("CUDA_HOME", "CUDA_PATH"):
        home = os.environ.get(var)
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found (looked at CUDA_HOME, CUDA_PATH, PATH and "
        "/usr/local/cuda): the CUDA kernels of repro_torch cannot be built")


def source_digest() -> str:
    """Hash of every file under ``csrc/`` plus the compiler flags."""
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _lib_path(name: str) -> Path:
    return build_dir() / f"lib{name}_{source_digest()}.so"


def _compile_cmd(name: str, out: Path, extra: tuple[str, ...]) -> list[str]:
    return [_nvcc(), *NVCC_FLAGS, *extra, "-I", str(CSRC), "-o", str(out),
            str(CSRC / KERNEL_SOURCES[name])]


def build_all(verbose: bool = False) -> dict:
    """Compile every missing kernel library, all ``nvcc`` processes started
    together.  Returns ``{"seconds", "built", "flags", "log"}``; raises
    ``RuntimeError`` with the compiler's output if any build fails.
    ``verbose`` adds ``-Xptxas -v`` (registers / shared memory / spills go
    to the returned log)."""
    t0 = time.perf_counter()
    bdir = build_dir()
    bdir.mkdir(parents=True, exist_ok=True)
    extra = ("-Xptxas", "-v") if verbose else ()
    procs = []
    for name in KERNEL_SOURCES:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        procs.append((name, out, tmp, subprocess.Popen(
            _compile_cmd(name, tmp, extra), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for name, out, tmp, proc in procs:
        text, _ = proc.communicate()
        log.append(f"[{name}] {text.strip()}")
        if proc.returncode != 0:
            failed.append(name)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError(
            f"nvcc failed for {failed}:\n" + "\n".join(log))
    return {"seconds": time.perf_counter() - t0,
            "built": [p[0] for p in procs],
            "flags": list(NVCC_FLAGS), "log": "\n".join(log)}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``name`` (built first when missing)."""
    lib = _LIBS.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build_all()
        lib = _LIBS[name] = ctypes.CDLL(str(path))
    return lib


def check_launch(code: int, what: str) -> None:
    """Raise if a C entry point returned a non-zero ``cudaError_t``."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA launch failed (cudaError {code})")
