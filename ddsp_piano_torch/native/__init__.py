"""The host voice allocator in C++ (voice_allocator.cc), loaded via ctypes.

Counterpart of ddsp_piano_tpu/native. The shared library is built at first
use with the host's C++ compiler (``g++``, else ``c++``, found on PATH)
with ``-O3 -shared -fPIC -std=c++17`` only: no ``-march=native``, since the
build directory is shared by every process of a host and, in multi-host
runs, by several hosts. It goes to ``build/host/<hash>/`` at the
repository root, keyed by a hash of the source and the flags, never into
the package's source directory; the build holds the directory's file lock
(kernels/build.py ``build_lock``), so the workers of a host build once.

Nothing falls back silently: with no compiler on PATH,
:func:`available` prints one notice to stderr a process and returns False
(``roll_to_conditioning(use_native='auto')`` then runs the numpy loop); a
compiler that fails, or a library that fails to load, raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

from ddsp_piano_torch.kernels.build import build_lock

SOURCE = Path(__file__).resolve().parent / 'voice_allocator.cc'
BUILD_ROOT = Path(__file__).resolve().parents[2] / 'build' / 'host'
COMPILERS = ('g++', 'c++')
FLAGS = ('-O3', '-shared', '-fPIC', '-std=c++17')

# Calls of the C allocator, counted where it is called and nowhere else (a
# run shows which allocator its path went through).
CALLS: Dict[str, int] = {'allocate_voices': 0}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_noticed = False


class CompilerMissing(RuntimeError):
    """No C++ compiler on PATH, and the library is not built yet."""


def reset_calls() -> None:
    with _lock:
        for name in CALLS:
            CALLS[name] = 0


def library_path() -> Path:
    """Where the library of this source and these flags is (or goes)."""
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(' '.join(FLAGS).encode())
    return BUILD_ROOT / digest.hexdigest()[:16] / 'libvoice_allocator.so'


def compiler() -> Optional[str]:
    for name in COMPILERS:
        found = shutil.which(name)
        if found:
            return found
    return None


def _compile(target: Path) -> None:
    cxx = compiler()
    if cxx is None:
        raise CompilerMissing(
            f"no C++ compiler ({' or '.join(COMPILERS)}) on PATH to build "
            f"{target.name} from {SOURCE.name}")
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=target.parent)
    os.close(fd)
    proc = subprocess.run([cxx, *FLAGS, '-o', tmp, str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{cxx} failed to build {SOURCE.name} "
                           f"({proc.returncode}):\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, target)


def _load() -> ctypes.CDLL:
    """The loaded library, built first if it is not built yet."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        target = library_path()
        if not target.exists():
            target.parent.mkdir(parents=True, exist_ok=True)
            with build_lock(target.parent):
                if not target.exists():
                    _compile(target)
        try:
            lib = ctypes.CDLL(str(target))
        except OSError as e:
            raise RuntimeError(f"cannot load {target}: {e}") from e
        lib.allocate_voices.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float)]
        lib.allocate_voices.restype = None
        _lib = lib
        return lib


def available() -> bool:
    """True once the library is loaded (built first if need be). False
    only when no C++ compiler is on PATH to build it, after one notice to
    stderr a process; a failed build or load raises."""
    global _noticed
    try:
        _load()
        return True
    except CompilerMissing as e:
        with _lock:
            if not _noticed:
                _noticed = True
                print(f"ddsp_piano_torch.native: {e}; the voice allocator "
                      "runs as the numpy loop instead", file=sys.stderr)
        return False


def allocate_voices(roll: np.ndarray, n_synths: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """C++ voice allocation: (n_frames, 88, 2) roll ->
    ((n_frames, n_synths, 2) conditioning, (n_frames,) polyphony), both
    float32. Raises CompilerMissing if the library is not built and cannot
    be."""
    roll = np.ascontiguousarray(roll, np.float32)
    if roll.ndim != 3 or roll.shape[1:] != (88, 2):
        raise ValueError(f"roll must be (n_frames, 88, 2), got {roll.shape}")
    if not 1 <= n_synths <= 88:
        raise ValueError(f"n_synths must be in [1, 88], got {n_synths}")
    lib = _load()
    n_frames = roll.shape[0]
    conditioning = np.zeros((n_frames, n_synths, 2), np.float32)
    polyphony = np.zeros((n_frames,), np.float32)
    lib.allocate_voices(
        roll.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int64(n_frames), ctypes.c_int(n_synths),
        conditioning.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        polyphony.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    with _lock:
        CALLS['allocate_voices'] += 1
    return conditioning, polyphony
