#!/usr/bin/env python3
"""Same-call A/B of the additive synth's kernels on one NVIDIA GPU: K1
(the skipping forward, csrc/oscillator_skip.cu) and K4 (its backward,
csrc/oscillator_skip_bwd.cu) of this checkout against another checkout's,
at the same recorded inputs.

    python3 chip_oscillator_ab.py --other build/ab/parent

``--other`` is the root of another checkout of the repository, e.g. a
parent commit unpacked with ``git archive <commit> | tar -x -C
build/ab/parent``. It imports no JAX and nothing of ddsp_piano_tpu. Each
phase runs in a fresh process:

1. Record, with this checkout: K1's inputs at the v2 model's 3 s segment
   (chip_smoke.py phase 3); the same controls tiled to the training
   step's 96 voice rows, with a seeded cotangent for K4; K1's and K4's
   inputs at one full-width training step (chip_smoke.py phases 9-10).
   Each input's share of live cells is printed.
2. Four arms, in the order other, this, this, other. Each imports
   ddsp_piano_torch from its own checkout, builds its kernels, holds K1
   and K4 against that checkout's plain versions at every input (within
   chip_smoke.py's OSC_TOL and OSC_BWD_TOL), and times each: the wrapper
   call (CUDA events from before its host work to after its launch, as
   chip_smoke.py times a kernel) and the kernel on the card alone
   (torch.profiler), median and least-most of 25. Then it counts what its
   K1 and K4 instances issue, read from their SASS (cuobjdump next to
   nvcc).
3. Per input, both checkouts' medians and the ratio this / other.

Any failure (a build, a launch, a disagreement, a profiler that records
no launch of the kernel, a SASS that cannot be read) ends the run with a
non-zero exit code. Inputs and results go to build/oscillator_ab/.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

import chip_smoke as cs    # imports nothing of the package until called

OUT = os.path.join(cs.ROOT, 'build', 'oscillator_ab')
INPUTS = os.path.join(OUT, 'inputs.pt')
# Kernel -> (source, a piece of its kernels' symbol names).
KERNELS = {'K1': ('oscillator_skip', 'osc_skip_kernel'),
           'K4': ('oscillator_skip_bwd', 'osc_skip_bwd')}


def cells_text(kernel, controls, sr):
    """An input's cells below Nyquist: K1 skips all but the live ones, K4
    computes them all, silent ones on its short path."""
    f_lo, f_hi, a_lo, a_hi, _ = controls
    audible = torch.minimum(f_lo, f_hi) < sr / 2.0
    silent = audible & (a_lo == 0) & (a_hi == 0)
    n, below, quiet = f_lo.numel(), audible.sum().item(), silent.sum().item()
    if kernel == 'K1':
        return f"live {below - quiet}/{n} ({100 * (below - quiet) / n:.1f} %)"
    return (f"below Nyquist {below}/{n}: sounding {below - quiet} "
            f"({100 * (below - quiet) / max(below, 1):.1f} %), silent "
            f"{quiet}")


def record():
    from ddsp_piano_torch.device import set_f32_precision

    set_f32_precision()
    os.makedirs(cs.OUT_DIR, exist_ok=True)
    capture = {}
    cs.render_segment('cpu', capture)
    (segment, up, sr), = capture['oscillator_skip']
    cs.teacher_data()
    step, _ = cs.train_step_inputs()
    (step_k1, step_up, step_sr), = step['oscillator_skip']
    (step_k4, g, _, _), = step['oscillator_skip_bwd']
    rows = step_k1.f_lo.shape[0] // segment.f_lo.shape[0]
    tiled = [c.repeat(rows, 1, 1) for c in segment]
    g_tiled = 1e-3 * torch.randn(
        (tiled[0].shape[0], tiled[0].shape[1] * up),
        generator=torch.Generator().manual_seed(cs.SEED))
    cases = [
        ('K1', 'the v2 segment', segment, None, up, sr),
        ('K1', f'the segment tiled to {tiled[0].shape[0]} rows', tiled, None,
         up, sr),
        ('K1', 'the training step', step_k1, None, step_up, step_sr),
        ('K4', f'the segment tiled to {tiled[0].shape[0]} rows', tiled,
         g_tiled, up, sr),
        ('K4', 'the training step', step_k4, g, step_up, step_sr),
    ]
    saved, described = [], []
    for kernel, where, controls, grad, u, rate in cases:
        controls = [c.detach().cpu() for c in controls]
        name = f"{kernel} at {where} {tuple(controls[0].shape)}"
        saved.append(dict(name=name, kernel=kernel, controls=controls,
                          g=None if grad is None else grad.detach().cpu(),
                          up=u, sr=rate))
        described.append(dict(name=name,
                              cells=cells_text(kernel, controls, rate)))
    os.makedirs(OUT, exist_ok=True)
    torch.save(saved, INPUTS)
    return described


def device_times(fn, symbol, n=cs.N_TIMED):
    """The card's own time, ms, of each launch of the kernel whose name
    holds ``symbol`` over ``n`` calls of ``fn`` (torch.profiler, after a
    warm-up call)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    cs.sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        cs.sync()
    return [e.time_range.elapsed_us() / 1e3 for e in prof.events()
            if e.device_type.name == 'CUDA' and symbol in e.name]


def sass_counts(build, source, symbol):
    """Per kernel instance of ``source`` whose name holds ``symbol``: its
    instructions, the float32 ones (FADD, FMUL, FFMA, FSETP) and those of
    them with an operand from the constant bank (c[..][..], or a uniform
    register that ULDC filled), ULDC, shared (LDS) and global (LDG) loads,
    FRND and BSSY (a branch around a divergent region)."""
    cuobjdump = os.path.join(os.path.dirname(build.nvcc_path()), 'cuobjdump')
    lib = build._build_dir() / f'lib{source}.so'
    try:
        sass = subprocess.run([cuobjdump, '-sass', str(lib)],
                              capture_output=True, text=True, check=True,
                              timeout=120).stdout
    except (OSError, subprocess.SubprocessError) as e:
        cs.fail(f"cuobjdump -sass {lib}: {e}")
    counts = {}
    for fn in sass.split('Function : ')[1:]:
        head = fn.splitlines()[0].strip()
        if symbol not in head:
            continue
        ops = [line.split(';')[0].split('*/')[-1].split()
               for line in fn.splitlines() if line.strip().startswith('/*')]
        ops = [o[1:] if o and o[0].startswith('@') else o for o in ops]
        ops = [o for o in ops if o]
        base = [o[0].split('.')[0] for o in ops]
        fp = [o for o, b in zip(ops, base)
              if b in ('FADD', 'FMUL', 'FFMA', 'FSETP')]
        counts[head] = dict(
            instructions=len(ops), fp32=len(fp),
            fp32_constant=sum(1 for o in fp if any(
                a.lstrip('-|').startswith(('c[', 'UR')) for a in o[1:])),
            **{op: base.count(op)
               for op in ('ULDC', 'LDS', 'LDG', 'FRND', 'BSSY')})
    if not counts:
        cs.fail(f"no kernel named *{symbol}* in the SASS of {lib}")
    return counts


def spread(times):
    return dict(median=statistics.median(times), least=min(times),
                most=max(times), n=len(times))


def peak_share(got, want):
    return ((got - want).abs().max()
            / max(want.abs().max().item(), 1e-30)).item()


def arm(root):
    """Check and time this process's checkout, ``root``: its package comes
    first on the path, ahead of this script's directory."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import ddsp_piano_torch

    found = os.path.dirname(os.path.dirname(os.path.abspath(
        ddsp_piano_torch.__file__)))
    if found != root:
        cs.fail(f"ddsp_piano_torch came from {found}, not {root}")
    from ddsp_piano_torch.device import set_f32_precision
    from ddsp_piano_torch.kernels import build
    from ddsp_piano_torch.kernels import oscillator as kosc
    from ddsp_piano_torch.ops.oscillator import FramewiseOscControls

    set_f32_precision()
    build.build_all()
    rows = []
    for case in torch.load(INPUTS):
        controls = FramewiseOscControls(*(c.to(cs.DEV)
                                          for c in case['controls']))
        up, sr = case['up'], case['sr']
        if case['kernel'] == 'K1':
            fn = lambda: kosc.render_framewise_skip_cuda(controls, up, sr)
            with torch.inference_mode():
                err = peak_share(fn(), kosc.render_framewise_plain(
                    controls, up, sr))
            tol = cs.OSC_TOL
        else:
            g = case['g'].to(cs.DEV)
            fn = lambda: kosc.render_framewise_skip_bwd_cuda(controls, g, up,
                                                             sr)
            err = max(peak_share(a, w) for a, w in zip(
                fn(), kosc.render_framewise_vjp_plain(controls, g, up, sr)))
            tol = cs.OSC_BWD_TOL
        if not (np.isfinite(err) and err <= tol):
            cs.fail(f"{root}: {case['name']} differs from its plain version "
                    f"by {err} of peak > {tol}")
        call = cs.event_times(fn)
        device = device_times(fn, KERNELS[case['kernel']][1])
        if len(device) != cs.N_TIMED:
            cs.fail(f"{root}: {case['name']}: the profiler recorded "
                    f"{len(device)} launches of {cs.N_TIMED}")
        rows.append(dict(name=case['name'], err=err, call=spread(call),
                         device=spread(device)))
        torch.cuda.empty_cache()
    sass = {kernel: sass_counts(build, source, symbol)
            for kernel, (source, symbol) in KERNELS.items()}
    return dict(root=root, rows=rows, sass=sass)


def child(flags, what):
    """Run this script with ``flags`` in a fresh process; its last line of
    output is its result."""
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), *flags],
                          cwd=cs.ROOT, capture_output=True, text=True,
                          timeout=1200)
    if proc.returncode != 0:
        cs.fail(f"{what} exited {proc.returncode}:\n{proc.stdout[-3000:]}\n"
                f"{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def ms_text(s):
    return f"{s['median']:.4f} ms ({s['least']:.4f}-{s['most']:.4f})"


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--other', help="root of the checkout to compare "
                        "this one with")
    parser.add_argument('--record', action='store_true',
                        help=argparse.SUPPRESS)
    parser.add_argument('--arm', help=argparse.SUPPRESS)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        cs.fail("no CUDA device: this A/B needs one NVIDIA GPU")
    if args.record:
        print(json.dumps(record()))
        return
    if args.arm:
        print(json.dumps(arm(args.arm)))
        return
    other = os.path.abspath(args.other or '')
    if not os.path.isfile(os.path.join(other, 'ddsp_piano_torch', 'kernels',
                                       'oscillator.py')):
        cs.fail(f"--other {args.other!r} is no checkout of ddsp_piano_torch")

    card = cs.card_line()
    print(card, flush=True)
    cases = child(['--record'], 'recording the inputs')
    for case in cases:
        print(f"input {case['name']}: {case['cells']}", flush=True)
    arms = []
    for label, root in (('other', other), ('this', cs.ROOT),
                        ('this', cs.ROOT), ('other', other)):
        result = child(['--arm', root], f"the {label} arm ({root})")
        result['label'] = label
        arms.append(result)
        for row in result['rows']:
            print(f"{label} ({root}) {row['name']}: err {row['err']:.3g} of "
                  f"peak; call {ms_text(row['call'])}; card "
                  f"{ms_text(row['device'])}", flush=True)
        for kernel, instances in result['sass'].items():
            for head, c in instances.items():
                print(f"{label} SASS {kernel} {head}: " + ', '.join(
                    f"{k} {v}" for k, v in c.items()), flush=True)
    for i, case in enumerate(cases):
        parts = []
        for what in ('device', 'call'):
            med = {label: [a['rows'][i][what]['median'] for a in arms
                           if a['label'] == label]
                   for label in ('this', 'other')}
            parts.append(
                f"{'card' if what == 'device' else 'call'} this "
                + ' / '.join(f"{m:.4f}" for m in med['this']) + " other "
                + ' / '.join(f"{m:.4f}" for m in med['other'])
                + f" ms, this / other "
                f"{statistics.mean(med['this']) / statistics.mean(med['other']):.3f}")
        print(f"A/B {case['name']}: " + '; '.join(parts), flush=True)
    with open(os.path.join(OUT, 'result.json'), 'w') as f:
        json.dump(dict(card=card, other=other, cases=cases, arms=arms), f,
                  indent=1)
    print(json.dumps({'ok': True, 'card': card}))


if __name__ == '__main__':
    main()
