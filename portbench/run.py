"""Run one cell of the benchmark of ddsp_piano_torch on this machine's
cards and print its result as the last line of standard output.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

The cell is an entry of BENCHMARK.json's workloads; its configuration
(configs/<config>.json), traffic mix (traffic/<mix>.json, whose 'loop'
names the module of loops/ that runs it) and limits (limits/<cell>.json)
are found by name. With --trace 0 the line carries the cell's end-to-end
metrics, with --trace 1 its per-layer metrics (metrics/<metric>.py), read
from a profiled sub-window. Kernel builds and caches stay in the checkout's
build/ directory. The run fails, printing no result, without enough CUDA
cards or when JAX or the JAX package has been loaded, in this process or
in any rank it started.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import os
import sys
import time
from pathlib import Path

_START = time.perf_counter()
ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def configure_process() -> None:
    """The run's environment, set before numpy, torch or the port load:
    kernel builds and caches under the checkout's build/ directory, one
    host thread for the CPU pools (the window's host work is the program's
    Python and its launches, and idle pool threads that spin take the
    cores it runs on), and glibc's allocator thresholds fixed: host
    buffers up to 32 MiB from the heap, and freed heap pages kept by the
    process. Left to glibc, the thresholds move as the process frees its
    first large buffers, and a fresh process lands by chance in one of two
    states: the audio copied back each request reuses pages the process
    has touched (~1 ms for 8 x 10 s rows on an H100 host), or faults in
    fresh pages (~5 ms; PERF.md). The benchmark fixes the first, where
    most fresh runs land."""
    for var, sub in (('TORCH_EXTENSIONS_DIR', 'torch_extensions'),
                     ('TRITON_CACHE_DIR', 'triton')):
        os.environ[var] = str(ROOT / 'build' / 'portbench' / sub)
    os.environ.setdefault('USE_FLAX', '0')
    for var in ('OMP_NUM_THREADS', 'MKL_NUM_THREADS', 'OPENBLAS_NUM_THREADS'):
        os.environ[var] = '1'
    try:
        libc = ctypes.CDLL(None)
        libc.mallopt(-3, 32 << 20)      # M_MMAP_THRESHOLD
        libc.mallopt(-1, 1 << 30)       # M_TRIM_THRESHOLD
    except (OSError, AttributeError):
        pass


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seed', type=int, required=True)
    parser.add_argument('--seconds', type=float, required=True)
    parser.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    configure_process()

    from portbench import harness

    clock = harness.Clock()
    clock.start = _START
    cell = harness.load_cell(args.workload)
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA "
              f"card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    loop = importlib.import_module(f"portbench.loops.{cell.mix['loop']}")
    result, checks = loop.run(cell, args.seed, args.seconds,
                                bool(args.trace), clock,
                                torch.device('cuda'))
    return report(result, checks)


def report(result, checks) -> int:
    """Print the result line, or nothing and return 3 where this process
    or a rank of the run (the result's 'forbidden') loaded JAX or the JAX
    package."""
    from portbench import harness

    result = dict(result)
    found = sorted(set(harness.forbidden_modules())
                   | set(result.pop('forbidden', [])))
    if found:
        print(f"portbench: modules of JAX or the JAX package were loaded: "
              f"{found}", file=sys.stderr)
        return 3
    print(f"portbench: {harness.power_limit()}", file=sys.stderr)
    harness.emit(result, checks)
    return 0


if __name__ == '__main__':
    sys.exit(main())
