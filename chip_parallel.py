#!/usr/bin/env python3
"""Data parallelism of the PyTorch port over the cards of one machine
(NCCL), a check and a measurement for a host of several NVIDIA GPUs.

    python3 chip_parallel.py [--steps 8]

Run from the root of a checkout on a machine with four cards (it needs at
least two, and runs what its cards allow). It imports no JAX and nothing
of ddsp_piano_tpu, and uses chip_smoke.py's helpers: it builds the
kernels, renders the teacher mini-MAESTRO and preprocesses it into a
cache (chip_smoke.py phases 2, 9 and 18), then, with maestro_v2 at full
width and 3 s segments:

1. ``train_single_phase`` on the cache, ``--steps`` steps each (student
   seed 1): one card at -b 6 (``--n_devices 1``); -b 6 over every card
   (``--n_devices`` left at its default: the largest count up to the
   cards that divides 6, 3 ranks of 2 rows on four cards, the recipe's
   case); -b 24 over four ranks of 6 rows. Per rank: the step's CUDA-event
   median, the wall time a step on the card (the span of steps 2 on over
   their count), the all-reduce's CUDA-event median and the gradient
   buffer's bytes; rows a second of the global batch over the wall a step.
2. The first step's reduced gradient of 3 NCCL ranks, 2 rows each,
   against the mean of the first step on each 2-row part on one card
   with its rows of the same draw (the magnitude term within 1e-5 of each
   leaf's peak) and against the one-card 6-row gradient (each leaf's gap
   printed beside the parts' mean's own gap to it); every cosine at least
   0.999, the losses within rtol 1e-5, the parameters bit-equal across the
   ranks after 3 steps.
3. ``evaluate_model --n_devices 4 -b 4 --duration 2`` over the test row
   against ``--n_devices 1``: losses within rtol 1e-5.
4. Two host processes (``python -m ddsp_piano_torch.train_single_phase
   --coordinator_address 127.0.0.1:<port> --num_processes 2 --process_id
   {0,1}``, two cards each through CUDA_VISIBLE_DEVICES, -b 24) against
   ``--n_devices 4`` on one host: their step times and rows a second, the
   four ranks' parameters bit-equal.
5. ``tests/test_torch_cuda.py`` (every kernel against its plain version,
   and each kernel's front door on cuda:1, cuda:2 and cuda:3 called from
   current device cuda:0), its summary line and the front doors' errors.

Each card's name and power limit comes first; one JSON line of the
numbers ends the output (also written to build/chip_smoke/parallel/
record.json).
A failed check ends the run with a non-zero exit code.
"""

import argparse
import json
import os
import socket
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import chip_smoke as cs

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(cs.OUT_DIR, 'parallel')
RECORD = os.path.join(OUT, 'record.json')
GRAD_RANKS = 3
GRAD_STEPS = 3


def fail(message):
    print(f"chip_parallel: {message}", file=sys.stderr)
    sys.exit(1)


def cards_text():
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()


def free_port():
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def run_summary(name, result, batch_size):
    """Per-rank step median, wall a step, reduce median and buffer bytes;
    rows a second over rank 0's wall a step."""
    ranks = result.get('ranks', [result])
    rows = []
    for r in ranks:
        steps = [t[0] for t in r['step_times'][1:]]
        reduce_ms = r['reduce_times'][1:]
        rows.append(dict(
            rank=r['rank'], step_ms=statistics.median(steps),
            wall_step_ms=r['wall_step_ms'],
            reduce_ms=(statistics.median(reduce_ms) if reduce_ms else None),
            reduce_bytes=r['reduce_bytes']))
        if not np.isfinite(r['step_losses']).all():
            fail(f"{name}: rank {r['rank']} losses {r['step_losses']}")
    for r in ranks[1:]:
        for n, v in ranks[0]['params'].items():
            if not torch.equal(r['params'][n], v):
                fail(f"{name}: rank {r['rank']}'s {n} differs from rank 0's")
    wall = rows[0]['wall_step_ms']
    return dict(name=name, batch=batch_size, ranks=len(ranks), per_rank=rows,
                rows_per_s=1e3 * batch_size / wall,
                losses=ranks[0]['step_losses'])


def train_run(name, batch_size, flags, steps):
    from ddsp_piano_torch import train_single_phase as cli

    exp = os.path.join(OUT, name)
    start = time.perf_counter()
    result = cli.main(cli.process_args(
        ['-b', str(batch_size), '-s', str(steps), '-e', '1', '--seed',
         str(cs.STUDENT_SEED)] + flags + [cs.CACHE_DIR, exp]),
        record_timeline=True)
    seconds = time.perf_counter() - start
    if 'trainer' in result:
        result = cli.portable_result(result)
    out = run_summary(name, result, batch_size)
    out['seconds'] = seconds
    return out


def grad_rank(batches):
    """One of GRAD_RANKS NCCL ranks: its first step's reduced gradients
    and GRAD_STEPS steps on its rows."""
    from ddsp_piano_torch.device import set_f32_precision
    from ddsp_piano_torch.parallel import mesh

    set_f32_precision()
    device = mesh.local_device('cuda')
    rows = [mesh.slice_local_batch(b) for b in batches]
    first = cs.parallel_first_step(rows[0], device)
    steps = cs.parallel_steps(rows, device)
    return dict(rank=mesh.rank(), first=first, params=steps['params'],
                losses=steps['losses'], reduce_ms=steps['reduce_ms'],
                reduce_bytes=steps['reduce_bytes'])


def gradient_check():
    from ddsp_piano_torch.parallel import mesh

    batches = cs.cache_batches(GRAD_STEPS)
    reference = cs.parallel_first_step(batches[0], cs.DEV)
    parts = cs.parallel_first_step(batches[0], cs.DEV, parts=GRAD_RANKS)
    ranks = mesh.launch(grad_rank, GRAD_RANKS, (batches,), 'cuda')
    out = {'control': {name: cs.gradient_stats(parts[name][1],
                                               reference[name][1])
                       for name in reference}}
    for r in ranks:
        for name, (losses, leaves) in r['first'].items():
            for key, value in reference[name][0].items():
                if not np.isclose(losses[key], value,
                                  rtol=cs.PARALLEL_LOSS_RTOL, atol=0):
                    fail(f"rank {r['rank']}: {name} {key} {losses[key]} "
                         f"against {value}")
            whole = cs.gradient_stats(leaves, reference[name][1])
            by_parts = cs.gradient_stats(leaves, parts[name][1])
            out.setdefault(name, []).append(
                dict(rank=r['rank'], whole=whole, parts=by_parts))
            if (name == 'magnitudes'
                    and by_parts[1] > cs.PARALLEL_NCCL_PARTS_TOL):
                fail(f"rank {r['rank']}: magnitude-term gradient "
                     f"{by_parts[0]} {by_parts[1]:.3g} of its peak from the "
                     "parts' mean")
            if min(whole[3], by_parts[3]) < cs.STEP_MIN_COSINE:
                fail(f"rank {r['rank']}: {name} gradient cosine "
                     f"{whole[3]} / {by_parts[3]}")
        for n, v in ranks[0]['params'].items():
            if not torch.equal(r['params'][n], v):
                fail(f"rank {r['rank']}'s {n} differs after {GRAD_STEPS} "
                     "steps")
    out['reduce_ms'] = [statistics.median(r['reduce_ms']) for r in ranks]
    out['reduce_bytes'] = ranks[0]['reduce_bytes']
    return out


def eval_check():
    from ddsp_piano_torch import evaluate_model as cli

    ckpt = os.path.join(cs.OUT_DIR, 'train_exp', 'phase_1', 'last_iter')
    ckpt_flags = ['--ckpt', ckpt] if os.path.isdir(ckpt) else []
    rows = {}
    for n in (1, 4):
        start = time.perf_counter()
        result = cli.main(cli.process_args(
            ckpt_flags + ['--duration', str(cs.EVAL_SECONDS), '-b', '4',
                          '--n_devices', str(n), cs.MAESTRO_DIR,
                          os.path.join(OUT, f'eval_{n}')]))
        rows[n] = ([r['loss_val'] for r in result['rows']],
                   time.perf_counter() - start)
    got, want = np.array(rows[4][0]), np.array(rows[1][0])
    rel = float(np.max(np.abs(got - want) / np.abs(want)))
    if len(got) != len(want) or not rel <= cs.PARALLEL_EVAL_RTOL:
        fail(f"evaluation over 4 ranks {got} against 1 {want}")
    return dict(rel=rel, seconds={n: v[1] for n, v in rows.items()},
                losses=want.tolist())


HOST_SCRIPT = r"""
import sys, torch
from ddsp_piano_torch import train_single_phase as cli
result = cli.main(cli.process_args(sys.argv[2:]), record_timeline=True)
torch.save(result, sys.argv[1])
"""


def two_hosts(steps):
    port = free_port()
    procs = []
    start = time.perf_counter()
    for pid, cards in enumerate(('0,1', '2,3')):
        argv = ['--coordinator_address', f'127.0.0.1:{port}',
                '--num_processes', '2', '--process_id', str(pid), '-b', '24',
                '-s', str(steps), '-e', '1', '--seed', str(cs.STUDENT_SEED),
                cs.CACHE_DIR, os.path.join(OUT, 'hosts')]
        env = dict(os.environ, CUDA_VISIBLE_DEVICES=cards)
        procs.append(subprocess.Popen(
            [sys.executable, '-c', HOST_SCRIPT,
             os.path.join(OUT, f'host{pid}.pt')] + argv, cwd=ROOT, env=env))
    codes = [p.wait(timeout=900) for p in procs]
    seconds = time.perf_counter() - start
    if any(codes):
        fail(f"the host processes exited {codes}")
    hosts = [torch.load(os.path.join(OUT, f'host{pid}.pt'),
                        weights_only=False) for pid in range(2)]
    ranks = hosts[0]['ranks'] + hosts[1]['ranks']
    if sorted(r['rank'] for r in ranks) != [0, 1, 2, 3]:
        fail(f"host ranks {[r['rank'] for r in ranks]}")
    out = run_summary('two hosts -b 24', dict(ranks=ranks), 24)
    out['seconds'] = seconds
    return out


def cuda_tests():
    proc = subprocess.run(
        [sys.executable, '-m', 'pytest', '--noconftest', '-p',
         'no:cacheprovider', '-q', '-s', 'tests/test_torch_cuda.py'],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    lines = proc.stdout.splitlines()
    doors = [ln.strip() for ln in lines if ' from cuda:0: worst error' in ln]
    summary = next((ln for ln in reversed(lines) if ' in ' in ln
                    and ('passed' in ln or 'failed' in ln)), '?')
    if proc.returncode:
        print(proc.stdout[-6000:], proc.stderr[-3000:], file=sys.stderr)
        fail(f"tests/test_torch_cuda.py: {summary}")
    return dict(summary=summary, doors=doors)


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--steps', type=int, default=8)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        fail("no CUDA device")
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        fail(f"{n_cards} card: this script needs several")
    sys.path.insert(0, ROOT)
    from ddsp_piano_torch.device import set_f32_precision

    set_f32_precision()
    os.makedirs(OUT, exist_ok=True)
    cards = cards_text()
    for line in cards:
        print(line, flush=True)
    seconds, _ = cs.build_kernels()
    print(f"build: {seconds:.1f} s", flush=True)
    cs.teacher_data()
    cs.preprocess_cache()
    record = dict(cards=cards)

    runs = [train_run('one card -b 6', 6, ['--n_devices', '1'], args.steps),
            train_run('every card -b 6', 6, [], args.steps)]
    if n_cards >= 4:
        runs.append(train_run('four cards -b 24', 24, ['--n_devices', '4'],
                              args.steps))
    for r in runs:
        print(f"train {r['name']}: {r['ranks']} rank(s), {args.steps} steps "
              f"in {r['seconds']:.1f} s (spawn included); " + '; '.join(
                  f"rank {x['rank']} step {x['step_ms']:.2f} ms, wall "
                  f"{x['wall_step_ms']:.2f} ms a step, reduce "
                  + ('-' if x['reduce_ms'] is None
                     else f"{x['reduce_ms']:.3f} ms")
                  + f" of {x['reduce_bytes']} bytes"
                  for x in r['per_rank'])
              + f"; {r['rows_per_s']:.1f} rows/s", flush=True)
    record['train'] = runs

    g = gradient_check()
    stats = lambda x: (f"worst {x[0]} {x[1]:.3g} of its peak, median "
                       f"{x[2]:.3g}, cosine {x[3]:.9f}, bit-equal {x[4]}")
    for name in ('magnitudes', 'v2'):
        print(f"gradient, {name}: {GRAD_RANKS} NCCL ranks x 2 rows, against "
              "one card's 6-row first step: " + '; '.join(
                  f"rank {x['rank']} {stats(x['whole'])}" for x in g[name])
              + "; against the mean of the three 2-row parts on one card: "
              + '; '.join(f"rank {x['rank']} {stats(x['parts'])}"
                          for x in g[name])
              + f"; that mean against the 6-row gradient (float32 control): "
              + stats(g['control'][name]), flush=True)
    print(f"gradient: parameters bit-equal across ranks after {GRAD_STEPS} "
          f"steps; reduce {g['reduce_ms']} ms of {g['reduce_bytes']} bytes",
          flush=True)
    record['gradient'] = g

    if n_cards >= 4:
        e = eval_check()
        print(f"evaluate_model --n_devices 4 -b 4 against --n_devices 1: "
              f"within {e['rel']:.3g} (rtol {cs.PARALLEL_EVAL_RTOL:g}); "
              f"sweep {e['seconds'][4]:.1f} s against {e['seconds'][1]:.1f} "
              "s (spawn included)", flush=True)
        record['evaluate'] = e
        h = two_hosts(args.steps)
        print(f"two hosts x 2 cards, -b 24: {h['seconds']:.1f} s; "
              + '; '.join(f"rank {x['rank']} step {x['step_ms']:.2f} ms, "
                          f"wall {x['wall_step_ms']:.2f} ms a step, reduce "
                          f"{x['reduce_ms']:.3f} ms"
                          for x in h['per_rank'])
              + f"; {h['rows_per_s']:.1f} rows/s; the four ranks' "
              "parameters bit-equal", flush=True)
        record['two_hosts'] = h

    t = cuda_tests()
    for line in t['doors']:
        print(f"front door: {line}", flush=True)
    print(f"tests/test_torch_cuda.py: {t['summary']}", flush=True)
    record['cuda_tests'] = t

    os.makedirs(os.path.dirname(RECORD), exist_ok=True)
    with open(RECORD, 'w') as f:
        json.dump(record, f, indent=1, default=str)
    print(json.dumps(record, default=str))


if __name__ == '__main__':
    main()
