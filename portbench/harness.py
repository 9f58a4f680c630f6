"""What every cell's run shares: the cell's files by name, the card, the
profiler's reading, the per-layer metric readers and the result line."""

from __future__ import annotations

import importlib.util
import json
import re
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'ddsp_piano_tpu')


@dataclass
class Cell:
    """One entry of BENCHMARK.json's workloads with what it names: its
    configuration's file, its traffic mix, its limits
    (limits/<cell>.json: each compared number's limit) and its metrics."""
    name: str
    chips: int
    config: Dict[str, Any]
    mix: Dict[str, Any]
    limits: Dict[str, float]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root``/BENCHMARK.json, with its configuration
    (configs/<config>.json) and its mix (traffic/<traffic>.json)."""
    spec = json.loads((root / 'BENCHMARK.json').read_text())
    cells = {w['name']: w for w in spec['workloads']}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has "
                       f"{sorted(cells)}")
    cell = cells[name]
    config = {c['name']: c for c in spec['configs']}[cell['config']]
    return Cell(
        name=name, chips=int(cell['chips']),
        config=json.loads((root / config['file']).read_text()),
        mix=json.loads((BENCH_DIR / 'traffic'
                        / f"{cell['traffic']}.json").read_text()),
        limits=json.loads((BENCH_DIR / 'limits'
                           / f'{name}.json').read_text())['limits'],
        end_to_end=[m for m in spec['end_to_end']
                    if name in m.get('workloads', [name])],
        per_layer=[m for m in spec['per_layer']
                   if name in m.get('workloads', [name])])


def metric_reader(name: str) -> Callable:
    """The ``read`` function of metrics/<name>.py."""
    path = BENCH_DIR / 'metrics' / f'{name}.py'
    spec = importlib.util.spec_from_file_location(
        f'portbench_metric_{name.replace(".", "_")}', path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def p95(values) -> float:
    """The 95th percentile, linear between order statistics."""
    return float(np.percentile(np.asarray(values, np.float64), 95))


def power_limit() -> Optional[str]:
    """nvidia-smi's name and power limit of the first card, or None."""
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN."""
    return sorted(m for m in list(sys.modules)
                  if m.split('.')[0] in FORBIDDEN)


# -- the profiler's reading ----------------------------------------------------

# Profiler kernel names of the port's kernels, by launch counter: (regex
# on the demangled name, device kernels a counted launch makes).
KERNEL_NAMES = {
    'oscillator_skip': (r'\bosc_skip_kernel\b', 1),
    'oscillator_skip_bwd': (r'\bosc_skip_bwd(_generic)?_kernel\b', 1),
    'gru_scan': (r'\bgru_scan_kernel\b', 1),
    'gru_scan_bwd': (r'\bgru_scan_bwd_kernel\b', 1),
    'note_release': (r'\bnote_release_kernel\b', 1),
    'note_release_res': (r'\bnote_release_res_kernel\b', 1),
    'note_release_bwd': (r'\bnote_release_bwd_kernel\b', 1),
    'oscillator_full': (r'\bosc_full_kernel\b', 1),
    'voice_allocator': (r'\bvoice_allocator_(classify|walk|fill)\b', 3),
}


@dataclass
class Trace:
    """What a traced sub-window gives the per-layer readers.

    kind: 'serve', 'train' or 'dp'; window_s: the sub-window's wall
    seconds; units: requests or steps in it; device: {kernel name:
    (seconds, events)} of every device operation; launches: the port's
    launch counters over it; busy_s; spans: {name: [seconds]} (the
    benchmark's host spans and the program's CUDA-event spans); bounds:
    {kernel counter: least seconds over the sub-window's launches};
    model_flops over the sub-window; peak_bytes of device memory."""
    kind: str
    window_s: float
    units: int
    device: Dict[str, Tuple[float, int]] = field(default_factory=dict)
    launches: Dict[str, int] = field(default_factory=dict)
    busy_s: float = 0.0
    spans: Dict[str, List[float]] = field(default_factory=dict)
    bounds: Dict[str, float] = field(default_factory=dict)
    model_flops: float = 0.0
    peak_bytes: int = 0
    top_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)

    def kernel_seconds(self, counter: str) -> Optional[float]:
        """Device seconds of a port kernel over the sub-window; None when
        it did not launch. Raises when the profiler's events of it do not
        match its launch counter."""
        pattern, per_launch = KERNEL_NAMES[counter]
        seconds, events = 0.0, 0
        for name, (s, n) in self.device.items():
            if re.search(pattern, name):
                seconds += s
                events += n
        launches = self.launches.get(counter, 0)
        if events != launches * per_launch:
            raise RuntimeError(
                f"the profiler recorded {events} events of {counter} "
                f"against {launches} counted launches x {per_launch}")
        return seconds if launches else None


def _interval_union(intervals: List[Tuple[float, float]]
                    ) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def read_profile(prof, trace: Trace) -> None:
    """Fill ``trace`` from a torch.profiler run over the sub-window: each
    device operation's seconds and events, the device's busy seconds (the
    union of its operations' intervals, averaged over the cards that ran
    any), the ten longest operations by total and the ten longest idle
    gaps, each named by the innermost host operation under way when it
    began."""
    from torch.autograd import DeviceType

    device_iv: Dict[int, List[Tuple[float, float]]] = {}
    host_ops: List[Tuple[float, float, str]] = []
    totals: Dict[str, List[float]] = {}
    for ev in prof.events():
        start, end = ev.time_range.start, ev.time_range.end
        if getattr(ev, 'is_user_annotation', False):
            continue            # a host range drawn on the device's line
        if ev.device_type == DeviceType.CUDA:
            device_iv.setdefault(ev.device_index, []).append((start, end))
            entry = totals.setdefault(ev.name, [0.0, 0])
            entry[0] += (end - start) * 1e-6
            entry[1] += 1
        elif ev.device_type == DeviceType.CPU:
            host_ops.append((start, end, ev.name))
    if not device_iv:
        raise RuntimeError("the profiler recorded no device operation")
    trace.device = {k: (v[0], int(v[1])) for k, v in totals.items()}
    unions = {d: _interval_union(iv) for d, iv in device_iv.items()}
    trace.busy_s = float(np.mean([sum(b - a for a, b in u) * 1e-6
                                  for u in unions.values()]))
    trace.top_ops = sorted(((k, v[0]) for k, v in totals.items()),
                           key=lambda kv: -kv[1])[:10]
    union = unions[min(unions)]
    gaps = sorted(((b0, a1) for (_, b0), (a1, _) in zip(union, union[1:])),
                  key=lambda g: g[0] - g[1])[:10]
    host_ops.sort()
    named = []
    for g0, g1 in gaps:
        under = [op for op in host_ops if op[0] <= g0 < op[1]]
        name = min(under, key=lambda op: op[1] - op[0])[2] if under \
            else 'python'
        named.append((name, (g1 - g0) * 1e-6))
    trace.idle_gaps = named


def per_layer_metrics(cell: Cell, trace: Trace) -> Dict[str, Dict]:
    """Each of the cell's per-layer metrics that its reader finds."""
    out = {}
    for m in cell.per_layer:
        value = metric_reader(m['name'])(trace)
        if value is not None:
            out[m['name']] = {'value': float(value), 'unit': m['unit']}
    return out


# -- the run's clock and result ------------------------------------------------


class Clock:
    """Set-up seconds from the process's start of work."""

    def __init__(self):
        self.start = time.perf_counter()

    def seconds(self) -> float:
        return time.perf_counter() - self.start


def device_block(count: int, trace: Optional[Trace] = None) -> Dict:
    import torch

    peak = max(torch.cuda.max_memory_allocated(i) for i in range(count))
    block = {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
             'count': count, 'memory_peak_bytes': int(peak)}
    if trace is not None:
        block['busy_s'] = trace.busy_s
        block['window_s'] = trace.window_s
    return block


def emit(result: Dict, checks: Dict[str, Tuple[float, float]]) -> None:
    """Print the compared numbers beside their limits as the last lines of
    standard error, and the result as the last line of standard output
    with the same numbers under 'checks', its last key."""
    for name, (value, limit) in checks.items():
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    result = dict(result)
    result['checks'] = {name: {'value': value, 'limit': limit}
                        for name, (value, limit) in checks.items()}
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
