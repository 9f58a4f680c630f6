"""Build the CUDA kernels at first use and load them through ctypes.

Each ``csrc/*.cu`` file (with the ``csrc/*.cuh`` headers it includes) is
compiled on its own by ``nvcc`` into a shared library with a plain C
interface (no PyTorch headers, so a build takes
seconds; the GRU sources, 64 kernel instances each (32 float32, 32 bf16),
about a minute);
the sources of a group compile in parallel, at the first call of any of
them (``GROUPS``: the surrogate model's decay oscillator builds only where
that model runs). Outputs go to
``build/kernels/<hash>/`` at the repository root, keyed by a hash of the
sources and flags, so an edited source rebuilds and an unchanged one is
reused. Nothing here runs at import time.

Several processes of one host (the ranks of a data-parallel run) build
once: the build holds a file lock in its directory, so the first process
compiles and the others wait for it and then find the libraries built.

Every C entry point returns ``cudaGetLastError()``; :func:`check` raises on
a non-zero code. Kernels launch on ``torch.cuda.current_stream()`` and
allocate nothing: the wrappers allocate outputs with ``torch.empty``, so a
CUDA graph can capture them. ``LAUNCHES`` counts the launches the card
ran: a wrapper counts each call, and a capture's calls are taken back out
and added again for each replay of its graph.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

from ddsp_piano_torch import tracing

CSRC = Path(__file__).resolve().parent.parent / 'csrc'
BUILD_ROOT = Path(__file__).resolve().parents[2] / 'build' / 'kernels'

ARCH_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a')
COMMON_FLAGS = ('-std=c++17', '-O3', '-shared', '-Xcompiler', '-fPIC',
                '-Xptxas', '-v')
# Per-source flags: the oscillator and NoteRelease kernels round every
# multiply and add on its own, as their plain PyTorch versions do.
SOURCE_FLAGS = {
    'note_release': ('--fmad=false',),
    'oscillator_skip': ('--fmad=false',),
    'gru_scan': (),
    'note_release_bwd': ('--fmad=false',),
    'oscillator_skip_bwd': ('--fmad=false',),
    'gru_scan_bwd': (),
    'oscillator_full': ('--fmad=false',),
    'voice_allocator': (),
    'oscillator_decay': ('--fmad=false',),
    'oscillator_decay_bwd': ('--fmad=false',),
}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
SIGNATURES = {
    'note_release': {
        'note_release_launch': (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                _P),
    },
    'gru_scan': {
        'gru_scan_launch': (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                            _P),
        'gru_scan_plan': (_I, _I, _P),
    },
    'oscillator_skip': {
        'osc_skip_launch': (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F,
                            _F, _P),
    },
    'note_release_bwd': {
        'note_release_res_launch': (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                    _I, _I, _P),
        'note_release_bwd_launch': (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                    _I, _I, _I, _I, _I, _P),
    },
    'gru_scan_bwd': {
        'gru_scan_bwd_launch': (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                _I, _I, _I, _P),
        'gru_scan_bwd_plan': (_I, _I, _P),
    },
    'oscillator_skip_bwd': {
        'osc_skip_bwd_launch': (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                _I, _I, _F, _F, _P),
    },
    'oscillator_full': {
        'osc_full_launch': (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F,
                            _F, _I, _I, _I, _P),
    },
    'voice_allocator': {
        'voice_allocator_launch': (_P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    },
    'oscillator_decay': {
        'osc_decay_launch': (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                             _I, _F, _F, _P),
    },
    'oscillator_decay_bwd': {
        'osc_decay_bwd_launch': (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                 _I, _I, _I, _F, _F, _P),
    },
}

# Sources built together, at the first call of any of them: the surrogate
# model's decay oscillator (K10, K11) apart from the rest, so that a model
# that never runs it never waits for its build. build_all builds every
# group.
GROUPS = {
    'surrogate': ('oscillator_decay', 'oscillator_decay_bwd'),
}
GROUPS['common'] = tuple(name for name in SIGNATURES
                         if not any(name in g for g in GROUPS.values()))

# The kernels, by the name of their launch counter: K1-K3 (inference),
# K4-K7 (gradients), K8 (the all-partials oscillator), K9 (the voice
# allocator of the serving path) and K10-K11 (the surrogate synth's
# decaying partials, forward and backward). note_release_bwd.cu holds two
# of them.
KERNELS = ('oscillator_skip', 'gru_scan', 'note_release',
           'oscillator_skip_bwd', 'gru_scan_bwd', 'note_release_res',
           'note_release_bwd', 'oscillator_full', 'voice_allocator',
           'oscillator_decay', 'oscillator_decay_bwd')

# Launches of each kernel that the card ran (a run shows its path went
# through the kernels). A wrapper counts its launch where it launches the
# kernel and nowhere else. Under CUDA graph capture a wrapper's launch runs
# nothing: whoever captures takes the capture's counts back out
# (take_launches) and adds them once for each replay of the graph
# (add_launches), as the training step's graphs do
# (training/trainer.py).
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}
# Of those, the launches of K2's and K5's bf16 instance (the bf16 control
# networks, nn.layers.enable_bf16_control).
BF16_LAUNCHES: Dict[str, int] = {'gru_scan': 0, 'gru_scan_bwd': 0}

# A copy of both counters: (LAUNCHES, BF16_LAUNCHES).
Counts = Tuple[Dict[str, int], Dict[str, int]]


def reset_launches() -> None:
    for counts in (LAUNCHES, BF16_LAUNCHES):
        for name in counts:
            counts[name] = 0


def launch_counts() -> Counts:
    """A copy of LAUNCHES and BF16_LAUNCHES."""
    return dict(LAUNCHES), dict(BF16_LAUNCHES)


def take_launches(since: Counts) -> Counts:
    """Take the launches counted after ``since`` (launch_counts) back out
    of the counters, and return them."""
    taken = tuple({k: counts[k] - before.get(k, 0) for k in counts}
                  for counts, before in zip((LAUNCHES, BF16_LAUNCHES), since))
    add_launches(taken, -1)
    return taken


def add_launches(counts: Counts, times: int = 1) -> None:
    """Add ``times`` x ``counts`` (take_launches) to the counters."""
    for total, part in zip((LAUNCHES, BF16_LAUNCHES), counts):
        for k, n in part.items():
            total[k] += times * n


def nvcc_path() -> str:
    found = shutil.which('nvcc')
    if found:
        return found
    cuda_home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    candidate = os.path.join(cuda_home, 'bin', 'nvcc')
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc (set CUDA_HOME).")


def _flags(name: str):
    return ARCH_FLAGS + COMMON_FLAGS + SOURCE_FLAGS[name]


def _build_dir() -> Path:
    digest = hashlib.sha256()
    for name in sorted(SIGNATURES):
        digest.update(name.encode())
        digest.update((CSRC / f'{name}.cu').read_bytes())
        digest.update(' '.join(_flags(name)).encode())
    for header in sorted(CSRC.glob('*.cuh')):
        digest.update(header.read_bytes())
    return BUILD_ROOT / digest.hexdigest()[:16]


@contextlib.contextmanager
def build_lock(out_dir: Path):
    """Hold the build directory's lock (one holder on the host at a
    time)."""
    with open(out_dir / '.lock', 'w') as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile every source of ``names`` (default: all) that is not built
    yet; one nvcc per source, all started together, under the build
    directory's lock. Returns {name: ptxas report} for fresh builds."""
    out_dir = _build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    with build_lock(out_dir):
        return _build_missing(out_dir, names)


def _build_missing(out_dir: Path,
                   names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    nvcc = nvcc_path()
    procs = {}
    for name in (SIGNATURES if names is None else names):
        target = out_dir / f'lib{name}.so'
        if target.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix='.so', dir=out_dir)
        os.close(fd)
        cmd = [nvcc, *_flags(name), '-o', tmp, str(CSRC / f'{name}.cu')]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target)
    reports = {}
    failures = []
    for name, (proc, tmp, target) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, target)
        (out_dir / f'lib{name}.log').write_text(log)
        reports[name] = log
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return reports


def build_report(name: str) -> str:
    """nvcc's output (with ptxas -v: registers, stack frame, spills) of the
    build of source ``name``, kept beside its library; '' if not built."""
    log = _build_dir() / f'lib{name}.log'
    return log.read_text() if log.exists() else ''


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The built library of one source, with argtypes/restype declared.
    With tracing on, its first call for a source is the span
    ``kernels.load`` (the build of whatever its group misses, and the
    load)."""
    with tracing.span('kernels.load'):
        build_all(next(g for g in GROUPS.values() if name in g))
        lib = ctypes.CDLL(str(_build_dir() / f'lib{name}.so'))
        for fn_name, argtypes in SIGNATURES[name].items():
            fn = getattr(lib, fn_name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
    return lib


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}")


def stream_handle(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream
