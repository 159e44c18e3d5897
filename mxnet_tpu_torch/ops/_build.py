"""Build the port's CUDA sources at first use and load them with ctypes.

Each `ops/csrc/<name>.cu` is compiled by nvcc for Hopper (sm_90a) into a
shared library with a plain C interface, under `build/` at the repository
root, named by a hash of the sources and flags so that an edited source is
rebuilt and an unchanged one is loaded as it is. Several sources build in
parallel, one nvcc each. There is no fallback: a missing nvcc or a failed
build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["build", "library", "build_log"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for var in ("CUDA_HOME", "CUDA_PATH"):
        home = os.environ.get(var)
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")  # the toolkit's default home
    if default.is_file():
        return str(default)
    raise RuntimeError(
        "nvcc not found: set CUDA_HOME or put nvcc on PATH to build the "
        "port's CUDA kernels")


def _output(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    if not src.is_file():
        raise FileNotFoundError(f"no CUDA source {src}")
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [src, *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_log(name: str) -> str:
    """nvcc's output (with ptxas's register and spill report) from the build
    of `name`, or "" when the library was built by an earlier process."""
    log = _output(name).with_suffix(".log")
    return log.read_text() if log.is_file() else ""


def build(names) -> list[str]:
    """Compile every source in `names` whose library is not built yet, one
    nvcc process each, all started together. Returns the names it built."""
    todo = [(n, _output(n)) for n in names]
    todo = [(n, out) for n, out in todo if not out.is_file()]
    if not todo:
        return []
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, out in todo:
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return [name for name, _ in todo]


def library(name: str) -> ctypes.CDLL:
    """The loaded library of `ops/csrc/<name>.cu`, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = _loaded[name] = ctypes.CDLL(str(_output(name)))
    return lib
