"""ctypes bindings for the native prefetching dataloader (port of
``datasets/native_loader.py``).

``native/dataloader.cpp`` decodes TUM directories (16-bit depth and 8-bit
color PNGs) and ``.klg`` logs (zlib depth, JPEG color) in worker threads
into a bounded ring buffer, so host decode overlaps the device's work.
This module builds it with ``g++`` into ``instancefusion_tpu_torch/_build/``
(never into ``native/``), named by a digest of the source and the flags as
the CUDA kernels are (``ops/kernels/_build.py``), and loads it with ctypes.

``available()`` is False when the library cannot be built or loaded for
want of the compiler, the source, or libpng, libjpeg or zlib (headers or
shared libraries); ``_build/ifl_dataloader.log`` says which.  Any other
build failure raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import NamedTuple

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG.parent / "native" / "dataloader.cpp"
BUILD_DIR = _PKG / "_build"
LOG = BUILD_DIR / "ifl_dataloader.log"
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-Wall", "-shared")
LIBS = ("-lpng", "-ljpeg", "-lz", "-lpthread")
# What a failed build's log names when a development package is missing.
_MISSING = {"png.h": "libpng headers", "jpeglib.h": "libjpeg headers",
            "zlib.h": "zlib headers", "-lpng": "libpng", "-ljpeg": "libjpeg",
            "-lz": "zlib"}

_lib: ctypes.CDLL | None = None


class Unavailable(OSError):
    """The toolchain or a library the native loader needs is missing."""


def library_path() -> Path:
    digest = hashlib.sha1(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS + LIBS).encode())
    return BUILD_DIR / f"libifl_dataloader-{digest.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the loader unless it is built; raises ``Unavailable`` for a
    missing compiler, source or library, ``RuntimeError`` for any other
    failure (the compiler's output is in ``LOG``)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    if not SOURCE.exists():
        LOG.write_text(f"source not found: {SOURCE}\n")
        raise Unavailable(f"native loader source not found: {SOURCE}")
    target = library_path()
    if target.exists():
        return target
    cxx = shutil.which("g++")
    if cxx is None:
        LOG.write_text("g++ not found on PATH\n")
        raise Unavailable("g++ not found: the native loader cannot be built")
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    with open(LOG, "w") as log:
        rc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE), *LIBS],
                            stdout=log, stderr=subprocess.STDOUT).returncode
    if rc != 0:
        text = LOG.read_text()
        missing = [what for key, what in _MISSING.items()
                   if f"{key}: No such file" in text or f"cannot find {key}" in text]
        if missing:
            raise Unavailable(f"native loader needs {', '.join(missing)} (see {LOG})")
        raise RuntimeError(f"native loader build failed (g++ exit {rc}):\n{text}")
    os.replace(tmp, target)
    return target


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    path = build()
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:  # built elsewhere: a shared library it links is missing here
        LOG.write_text(f"{path} does not load: {e}\n")
        raise Unavailable(f"native loader does not load: {e}") from e
    for fn in (lib.ifl_open_tum, lib.ifl_open_klg):
        fn.restype = ctypes.c_void_p
        fn.argtypes = [ctypes.c_char_p] + [ctypes.c_int] * 4
    for fn in (lib.ifl_frame_count, lib.ifl_width, lib.ifl_height):
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p]
    lib.ifl_next.restype = ctypes.c_int
    lib.ifl_next.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.ifl_close.restype = None
    lib.ifl_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def available() -> bool:
    """Whether the native loader is built or can be built here."""
    try:
        _load()
    except Unavailable:
        return False
    return True


class NativeFrame(NamedTuple):
    depth: np.ndarray  # f32[H,W] meters
    rgb: np.ndarray  # u8[H,W,3]
    timestamp: float
    index: int  # the frame's index in the loader's own association list


class NativeSequence:
    """Iterator over the decoded frames of a TUM directory or a ``.klg`` log.

    Frames that fail to decode are skipped; each frame carries the index
    the loader gave it, so a skip never shifts what pairs with later frames.
    """

    def __init__(self, path: str, width: int = 640, height: int = 480,
                 queue_depth: int = 8, workers: int = 2):
        self._h = None
        lib = _load()
        opener = lib.ifl_open_klg if path.endswith(".klg") else lib.ifl_open_tum
        self._h = opener(path.encode(), width, height, queue_depth, workers)
        if not self._h:
            raise FileNotFoundError(f"cannot open sequence: {path}")
        self._lib = lib
        self.width = width
        self.height = height
        self.count = lib.ifl_frame_count(self._h)

    def __len__(self) -> int:
        return self.count

    def __iter__(self):
        depth = np.empty((self.height, self.width), np.float32)
        rgb = np.empty((self.height, self.width, 3), np.uint8)
        ts = ctypes.c_double()
        while self._h:
            r = self._lib.ifl_next(
                self._h,
                depth.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                ctypes.byref(ts),
            )
            if r == -1:
                return
            if r == -2:  # decode error: the loader skips the frame
                continue
            yield NativeFrame(depth.copy(), rgb.copy(), float(ts.value), int(r))

    def close(self) -> None:
        if self._h:
            self._lib.ifl_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()
