"""Build and load the CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into its own shared library, loaded with ``ctypes``.  Nothing
is built on import: a kernel's wrapper asks for its library at its first
launch, and ``build()`` starts one ``nvcc`` per source, all at once, for a
caller that wants every kernel ready up front.  Libraries are named by a
digest of their source, the shared headers and the flags, so an edited
source or header is rebuilt and a built one is reused.  They go to
``instancefusion_tpu_torch/_build/`` (listed in ``.gitignore``).

Several processes may build at once (the ranks of a shard group start
together): ``build`` holds an exclusive ``flock`` on ``_build/build.lock``
while it checks and compiles, so one process compiles and the others wait
and then load its libraries.  The lock goes with the process that holds it,
so a build cut off midway leaves none behind.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("icp", "tsdf", "raycast", "preprocess", "labels")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                           "the CUDA toolkit is installed")
    return found


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` is built, named by a digest of the source,
    the shared headers (``csrc/*.cuh``) and the flags."""
    digest = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


@contextlib.contextmanager
def _build_lock():
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build(names=SOURCES) -> dict[str, Path]:
    """Compile the named sources that are not built yet, all in parallel,
    under the build lock.

    ``nvcc``'s report (``-Xptxas -v``: registers, shared memory, spills) is
    kept beside each library as ``<name>.log``.  Raises if any build fails.
    """
    if all(library_path(n).exists() for n in names):
        return {name: library_path(name) for name in names}
    with _build_lock():
        return _build_missing(names)


def _build_missing(names) -> dict[str, Path]:
    missing = [n for n in names if not library_path(n).exists()]
    if not missing:
        return {name: library_path(name) for name in names}
    nvcc = _nvcc()
    procs = {}
    for name in missing:
        target = library_path(name)
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        log = open(BUILD_DIR / f"{name}.log", "w")
        procs[name] = (
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                stdout=log, stderr=subprocess.STDOUT,
            ),
            tmp, target, log,
        )
    failed = []
    for name, (proc, tmp, target, log) in procs.items():
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, target)
        else:
            failed.append(f"{name} (nvcc exit {rc}):\n"
                          + (BUILD_DIR / f"{name}.log").read_text())
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return {name: library_path(name) for name in names}


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it if needed.

    ``signatures`` maps each exported function to its ctypes argument
    types; every function returns the CUDA error code of its launches.
    """
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _loaded[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a launch returned a non-zero CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def check_tensors(tensors: dict, device) -> None:
    """Raise unless ``device`` is a CUDA device and every named tensor is
    contiguous and on it."""
    if device.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA tensors, not {device}")
    for name, t in tensors.items():
        if t.device != device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous tensor on {device}")


def check_quads(n: int, *rows) -> None:
    """Raise unless ``n`` (the block edge of K4 and K7, whose voxels split
    into z-runs of 4, or the row length of K8) is a multiple of 4 and each
    of ``rows`` starts 16-byte aligned: the kernels move 4 voxels a thread
    as one 16-byte access."""
    if n % 4:
        raise ValueError(f"block_size or row length {n} is not a multiple of 4")
    for t in rows:
        if t.data_ptr() % 16:
            raise ValueError("payload rows must start 16-byte aligned")


# (exported grid function, device index) -> blocks.
_grids: dict = {}


def resident_grid(lib: ctypes.CDLL, fn: str, device) -> int:
    """A persistent kernel's grid on ``device``: ``lib.<fn>`` reports the
    blocks the card holds at once (SMs x resident blocks).  Asked once a
    device, before any launch, so never inside a CUDA-graph capture."""
    key = (fn, torch.device(device).index)
    grid = _grids.get(key)
    if grid is None:
        out = ctypes.c_int(0)
        with torch.cuda.device(device):
            check(getattr(lib, fn)(ctypes.byref(out)), fn)
        grid = _grids[key] = out.value
    return grid


def stream_handle():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
