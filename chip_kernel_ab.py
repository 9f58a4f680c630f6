#!/usr/bin/env python3
"""Same-call A/B of hand-written kernels on one NVIDIA GPU, this checkout
against another checkout's, at the same recorded inputs: K1 (the skipping
oscillator, csrc/oscillator_skip.cu), K4 (its backward,
csrc/oscillator_skip_bwd.cu), K2 and K5 (the GRU recurrence and its
backward, csrc/gru_scan.cu and csrc/gru_scan_bwd.cu, their float32
instances), K3 (the NoteRelease recurrence of the
render, csrc/note_release.cu), K6 / K7 (NoteRelease on the training path
and its reverse walk, csrc/note_release_bwd.cu), K8 (the all-partials
oscillator, csrc/oscillator_full.cu) and K9 (the voice allocator of the
serving path, csrc/voice_allocator.cu).

    python3 chip_kernel_ab.py --other build/ab/parent [--kernels K3,K8]

``--other`` is the root of another checkout of the repository, e.g. a
parent commit unpacked with ``git archive <commit> | tar -x -C
build/ab/parent``. It imports no JAX and nothing of ddsp_piano_tpu. Each
phase runs in a fresh process:

1. Record, with this checkout: K1's and K3's inputs at the v2 model's
   3 s segment (chip_smoke.py phase 3); the same oscillator controls
   tiled to the training step's 96 voice rows, with a seeded cotangent for
   K4; K1's, K4's, K6's and K7's inputs at one full-width training step
   (chip_smoke.py phases 9-10); K6 / K7 at T = 2625 (the step's pitch
   repeated in time, its residual streams from the plain forward, seeded
   cotangents); K3 at the 10 s v2 render's input (T = 2625) and K8 at the
   dafx22 model's 3 s segment and 10 s render (the synthesize CLI with
   ``--oscillator full`` on the card); K9 at demo.mid's top 16 voices
   (10 s after the 0.5 s warm-up, chip_smoke.py phase 19) at b = 1 and 8
   and at the seeded over-capacity roll (4, 500, 16); K2 at the v2
   segment's two GRUs, at the 10 s render's and at its mono GRU tiled to
   the serve's 128 rows, and K2 and K5 at the training step's. Each
   input's share
   of live cells (K1, K4, K8), its release ties (K3, K6, K7) or the
   frames K9's walk takes and skips (the plain version's counts) is
   printed.
2. Four arms, in the order other, this, this, other. Each imports
   ddsp_piano_torch from its own checkout, builds its kernels, holds each
   kernel against that checkout's plain version at every input (K1 and K4
   within chip_smoke.py's OSC_TOL and OSC_BWD_TOL, K8 within OSC_TOL and
   within K8_K1_TOL of K1, K3, K6, K7 and K9 bit-exact, K2 within GRU_TOL
   and K5 within GRU_BWD_TOL; K9's plain version runs on the host),
   and times each: the wrapper call (CUDA events from before its host
   work to after its launch, as chip_smoke.py times a kernel) and the
   kernel on the card alone (chip_smoke.card_times: CUDA events between
   launches queued behind a spin kernel), median and least-most of 25.
   Then it prints each kernel's registers, stack frame and spills (ptxas
   -v), counts what each kernel's instances issue, read from their SASS
   (cuobjdump next to nvcc), whole and per loop body, and writes their
   SASS text.
3. Per input, both checkouts' medians and the ratio this / other, and
   whether the four arms' outputs are bit-equal (a digest of each); K2's
   and K5's must be.

Any failure (a build, a launch, a disagreement, a host too slow to queue
the timed launches, a SASS that cannot be read) ends the run with a
non-zero exit code. Inputs, results and SASS go to build/kernel_ab/.
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

OUT = os.path.join(cs.ROOT, 'build', 'kernel_ab')
INPUTS = os.path.join(OUT, 'inputs.pt')
# Kernel -> (source, a piece of its kernels' symbol names).
KERNELS = {'K1': ('oscillator_skip', 'osc_skip_kernel'),
           'K2': ('gru_scan', 'gru_scan_kernel'),
           'K3': ('note_release', 'note_release_kernel'),
           'K4': ('oscillator_skip_bwd', 'osc_skip_bwd'),
           'K5': ('gru_scan_bwd', 'gru_scan_bwd_kernel'),
           'K6': ('note_release_bwd', 'note_release_res_kernel'),
           'K7': ('note_release_bwd', 'note_release_bwd_kernel'),
           'K8': ('oscillator_full', 'osc_full_kernel'),
           'K9': ('voice_allocator', 'voice_allocator')}
LONG_T = 2625                  # frames of the 10 s render with its warm-up
# Kernels whose output must be the same bit for bit in every arm.
BIT_EQUAL_ARMS = ('K2', 'K5')
# The SASS opcodes counted for every kernel instance.
SASS_OPS = ('ULDC', 'LDS', 'LDG', 'STG', 'LDL', 'STL', 'LDGSTS', 'UBLKCP',
            'SYNCS', 'FRND', 'FSEL', 'MUFU', 'BSSY', 'BRA')
# Opcode classes of a loop body's count.
SASS_CLASSES = {
    'fp32': ('FADD', 'FMUL', 'FFMA', 'FSETP', 'FSEL', 'FMNMX', 'FRND',
             'FSET', 'FCHK'),
    'int': ('IMAD', 'IADD3', 'IADD', 'LOP3', 'SHF', 'ISETP', 'LEA', 'IMNMX',
            'SEL', 'IABS', 'I2F', 'F2I', 'F2F', 'POPC', 'FLO', 'SGXT',
            'BMSK', 'PRMT', 'UIADD3', 'UIMAD', 'ULOP3', 'USHF'),
    'shared': ('LDS', 'STS'), 'global': ('LDG', 'STG'),
    'local': ('LDL', 'STL'), 'constant': ('ULDC', 'LDC'),
    'branch': ('BRA', 'BSSY', 'BSYNC'), 'mufu': ('MUFU',)}


def cells_text(kernel, controls, sr):
    """An input's cells below Nyquist: K1 skips all but the live ones, K4
    computes them all, silent ones on its short path, K8 computes every
    cell."""
    f_lo, f_hi, a_lo, a_hi, _ = controls
    audible = torch.minimum(f_lo, f_hi) < sr / 2.0
    silent = audible & (a_lo == 0) & (a_hi == 0)
    n, below, quiet = f_lo.numel(), audible.sum().item(), silent.sum().item()
    if kernel == 'K1':
        return f"live {below - quiet}/{n} ({100 * (below - quiet) / n:.1f} %)"
    return (f"below Nyquist {below}/{n}: sounding {below - quiet} "
            f"({100 * (below - quiet) / max(below, 1):.1f} %), silent "
            f"{quiet}")


def cli_inputs(flags):
    """The kernel front doors' inputs of one 10 s render of demo.mid by
    the synthesize CLI on the card (chip_smoke.py phases 4 and 7), with
    ``flags`` added."""
    from ddsp_piano_torch import synthesize_midi_file as cli

    args = cli.process_args(
        flags + ['-d', str(cs.MAIN_PATH_SECONDS), '-u', '--seed',
                 str(cs.SEED), '--piano_type', str(cs.PIANO_TYPE),
                 '--device', cs.DEV.type, cs.DEMO_MIDI,
                 os.path.join(OUT, 'demo.wav')])
    shapes = {}
    with cs.capturing(shapes):
        cli.main(args)
    return shapes


def ties_text(steps, thr):
    """The (step, lane) cells where steps - threshold lands on a tie of
    the saturated relu's gradient (0 or 1)."""
    u = steps - thr
    return (f"threshold {float(thr):g}; steps - thr == 0 at "
            f"{int((u == 0).sum())} and == 1 at {int((u == 1).sum())} of "
            f"{steps.numel()} cells")


def long_note_release(x, thr, s0):
    """K6 and K7 inputs at T = LONG_T: the step's pitch repeated in time,
    the residual streams of the plain forward, seeded cotangents."""
    from ddsp_piano_torch.kernels import note_release as knr

    reps = -(-LONG_T // x.shape[0])
    x = x.repeat(reps, 1, 1)[:LONG_T].contiguous()
    out, _, steps = knr.note_release_scan_plain_res(x, thr, s0)
    prev = torch.cat([s0[None, :, 0], out[:-1, :, 0]], dim=0)
    gen = torch.Generator().manual_seed(cs.SEED)
    g_out = torch.randn(out.shape, generator=gen)
    g_state = torch.randn(s0.shape, generator=gen)
    return (x, thr, s0), (x, thr, prev, steps, g_out, g_state)


def voice_allocator_inputs():
    """K9's inputs, on the host: demo.mid's top 16 voices at b = 1 and 8
    (the serve's rows, chip_smoke.py phase 19) and the over-capacity
    churn roll."""
    from ddsp_piano_torch.data.io import load_midi_as_roll
    from ddsp_piano_torch.data.midi_encoders_device import top_voices
    from ddsp_piano_torch.data.rolls import churn_roll

    demo = load_midi_as_roll(cs.DEMO_MIDI, duration=cs.MAIN_PATH_SECONDS,
                             warm_up_duration=0.5)['roll']
    churn = np.stack([churn_roll(s, cs.VA_VOICES, cs.VA_CHURN[1])
                      for s in range(cs.VA_CHURN[0])])
    return [(f'demo.mid b={b}', top_voices(
                torch.from_numpy(np.repeat(demo, b, 0)), cs.VA_VOICES))
            for b in (1, 8)] + [
        ('the over-capacity roll', top_voices(torch.from_numpy(churn),
                                              cs.VA_VOICES))]


def walk_text(p, v):
    """The frames K9's walk takes (slow, fast) and skips, a row."""
    from ddsp_piano_torch.kernels import voice_allocator as va

    _, n_fast, n_skipped = va.allocate_plain(p, v, return_fast=True)
    t = p.shape[1]
    rows = [f"{t - f}/{f - k} {k}" for f, k in zip(n_fast.tolist(),
                                                      n_skipped.tolist())]
    return ("walked slow / fast, skipped, a row: " + ', '.join(rows[:4])
            + (' ...' if len(rows) > 4 else ''))


def record(kernels):
    from ddsp_piano_torch.device import set_f32_precision

    set_f32_precision()
    os.makedirs(cs.OUT_DIR, exist_ok=True)
    os.makedirs(OUT, exist_ok=True)
    cases = []
    if {'K1', 'K2', 'K3', 'K4'} & kernels:
        capture = {}
        cs.render_segment('cpu', capture)
        (segment, up, sr), = capture['oscillator_skip']
        nr_segment, = capture['note_release']
        cases.append(('K3', 'the v2 segment', nr_segment))
        # The float32 instance's arguments, as any checkout's wrapper
        # takes them.
        cases += [('K2', 'the v2 segment', args[:4])
                  for args in capture['gru_scan']]
    if {'K2', 'K3'} & kernels:
        render = cli_inputs([])
        nr_render, = render['note_release']
        cases.append(('K3', 'the v2 10 s render', nr_render))
        cases += [('K2', 'the v2 10 s render', args[:4])
                  for args in render['gru_scan']]
        # The serve's mono GRU at b = 8: the render's rows tiled 8 times.
        x_proj, rec_kernel, rec_bias, h0 = max(
            render['gru_scan'], key=lambda a: a[0].shape[1])[:4]
        cases.append(('K2', "the v2 10 s render's mono GRU tiled to the "
                      "serve's b = 8", (x_proj.repeat(1, 8, 1), rec_kernel,
                                        rec_bias, h0.repeat(8, 1))))
    if 'K8' in kernels:
        capture = {}
        cs.render_segment('cpu', capture, config='dafx22')
        full_segment, = capture['oscillator_skip']
        full_render, = cli_inputs(['-c', 'dafx22', '--oscillator', 'full'])[
            'oscillator_full']
        cases += [('K8', 'the dafx22 segment', full_segment),
                  ('K8', 'the dafx22 10 s render', full_render)]
    if {'K1', 'K2', 'K4', 'K5', 'K6', 'K7'} & kernels:
        cs.teacher_data()
        step, _ = cs.train_step_inputs()
        cases += [('K2', 'the training step', args[:4])
                  for args in step['gru_scan']]
        cases += [('K5', 'the training step', args[:6])
                  for args in step['gru_scan_bwd']]
    if {'K1', 'K4'} & kernels:
        (step_k1, step_up, step_sr), = step['oscillator_skip']
        (step_k4, g, _, _), = step['oscillator_skip_bwd']
        rows = step_k1.f_lo.shape[0] // segment.f_lo.shape[0]
        tiled = [c.repeat(rows, 1, 1) for c in segment]
        g_tiled = 1e-3 * torch.randn(
            (tiled[0].shape[0], tiled[0].shape[1] * up),
            generator=torch.Generator().manual_seed(cs.SEED))
        n = tiled[0].shape[0]
        cases += [
            ('K1', 'the v2 segment', (segment, up, sr)),
            ('K1', f'the segment tiled to {n} rows', (tiled, up, sr)),
            ('K1', 'the training step', (step_k1, step_up, step_sr)),
            ('K4', f'the segment tiled to {n} rows',
             (tiled, g_tiled, up, sr)),
            ('K4', 'the training step', (step_k4, g, step_up, step_sr)),
        ]
    if {'K6', 'K7'} & kernels:
        res, = step['note_release_res']
        bwd, = step['note_release_bwd']
        res, bwd = cs.to_cpu(res), cs.to_cpu(bwd)
        long_res, long_bwd = long_note_release(*res)
        cases += [('K6', 'the training step', res),
                  ('K7', 'the training step', bwd),
                  ('K6', f'T = {LONG_T}', long_res),
                  ('K7', f'T = {LONG_T}', long_bwd)]
    if 'K9' in kernels:
        cases += [('K9', where, args)
                  for where, args in voice_allocator_inputs()]
    saved, described = [], []
    for kernel, where, args in cases:
        if kernel not in kernels:
            continue
        args = cs.to_cpu(args)
        if kernel in ('K1', 'K4', 'K8'):
            # A list, not the controls' named tuple: torch.load reads
            # tensors in plain containers only.
            args = (list(args[0]),) + tuple(args[1:])
            shape = tuple(args[0][0].shape)
            text = cells_text(kernel, args[0], args[-1])
        elif kernel == 'K9':
            shape = tuple(args[0].shape)
            text = walk_text(*args)
        elif kernel in ('K2', 'K5'):
            shape = tuple(args[0].shape)
            text = f"u = {shape[2] // 3}, B = {shape[1]}, T = {shape[0]}"
        else:
            from ddsp_piano_torch.kernels import note_release as knr

            shape = tuple(args[0].shape)
            steps = (args[3] if kernel == 'K7' else
                     knr.note_release_scan_plain_res(*args[:3])[2])
            text = ties_text(steps, args[1])
        name = f"{kernel} at {where} {shape}"
        saved.append(dict(name=name, kernel=kernel, args=args))
        described.append(dict(name=name, cells=text))
    torch.save(saved, INPUTS)
    return described


def ptxas_text(report, symbol):
    """Registers, stack frame and spills of each kernel instance whose name
    holds ``symbol``, from a source's ptxas -v report."""
    lines = []
    for block in report.split('Compiling entry function')[1:]:
        head = block.split("'")[1] if "'" in block else block[:60]
        if symbol not in head:
            continue
        used = [ln.split('Used')[1].strip() for ln in block.splitlines()
                if 'Used' in ln and 'registers' in ln]
        frame = [ln.strip() for ln in block.splitlines()
                 if 'stack frame' in ln]
        lines.append(f"{head}: {'; '.join(used + frame)}")
    return lines


def loop_counts(ops):
    """Each loop of a kernel's SASS (a backward branch's body) of 16
    instructions or more: its first and last address and the count of each
    opcode class in it. ``ops``: (address, opcode, operands)."""
    loops = []
    for addr, base, operands in ops:
        if base != 'BRA':
            continue
        target = [a for a in operands if a.startswith('0x')]
        if not target or int(target[0], 16) >= addr:
            continue
        start = int(target[0], 16)
        body = [b for a, b, _ in ops if start <= a <= addr]
        if len(body) < 16:
            continue
        counts = {c: sum(b in names for b in body)
                  for c, names in SASS_CLASSES.items()}
        counts['other'] = len(body) - sum(counts.values())
        loops.append(dict(start=hex(start), end=hex(addr),
                          instructions=len(body), **counts))
    return loops


def sass_counts(build, source, symbol, dump=None):
    """Per kernel instance of ``source`` whose name holds ``symbol``: its
    instructions, the float32 ones (FADD, FMUL, FFMA, FSETP) and those of
    them with an operand from the constant bank (c[..][..], or a uniform
    register that ULDC filled), the count of each of SASS_OPS: loads
    from the constant bank (ULDC), shared memory (LDS), device memory
    (LDG) and local memory (LDL), stores (STG, STL), asynchronous copies
    (LDGSTS: cp.async; UBLKCP: cp.async.bulk), barrier operations (SYNCS:
    mbarrier), FRND, FSEL, MUFU, BSSY (a branch around a divergent region)
    and branches; and each loop body's count by opcode class
    (loop_counts). ``dump``, a path, gets the SASS text of those
    instances."""
    cuobjdump = os.path.join(os.path.dirname(build.nvcc_path()), 'cuobjdump')
    lib = build._build_dir() / f'lib{source}.so'
    try:
        sass = subprocess.run([cuobjdump, '-sass', str(lib)],
                              capture_output=True, text=True, check=True,
                              timeout=120).stdout
    except (OSError, subprocess.SubprocessError) as e:
        cs.fail(f"cuobjdump -sass {lib}: {e}")
    counts, texts = {}, []
    for fn in sass.split('Function : ')[1:]:
        head = fn.splitlines()[0].strip()
        if symbol not in head:
            continue
        texts.append('Function : ' + fn)
        ops = []
        for line in fn.splitlines():
            line = line.strip()
            if not line.startswith('/*') or '*/' not in line:
                continue
            addr, rest = line[2:].split('*/', 1)
            words = rest.split(';')[0].replace(',', ' ').split()
            if words and words[0].startswith('@'):
                words = words[1:]
            if not words:
                continue
            try:
                ops.append((int(addr, 16), words[0].split('.')[0], words[1:]))
            except ValueError:
                continue
        base = [b for _, b, _ in ops]
        fp = [o for _, b, o in ops if b in ('FADD', 'FMUL', 'FFMA', 'FSETP')]
        counts[head] = dict(
            instructions=len(ops), fp32=len(fp),
            fp32_constant=sum(1 for o in fp if any(
                a.lstrip('-|').startswith(('c[', 'UR')) for a in o)),
            **{op: base.count(op) for op in SASS_OPS},
            loops=loop_counts(ops))
    if not counts:
        cs.fail(f"no kernel named *{symbol}* in the SASS of {lib}")
    if dump:
        with open(dump, 'w') as f:
            f.write('\n'.join(texts))
    return counts


def spread(times):
    return dict(median=statistics.median(times), least=min(times),
                most=max(times), n=len(times))


def peak_share(got, want):
    return ((got - want).abs().max()
            / max(want.abs().max().item(), 1e-30)).item()


def case_call(case):
    """(the kernel's wrapper call, its error against the plain version, the
    tolerance) for a recorded case, on the card."""
    from ddsp_piano_torch.kernels import gru as kgru
    from ddsp_piano_torch.kernels import note_release as knr
    from ddsp_piano_torch.kernels import oscillator as kosc
    from ddsp_piano_torch.ops.oscillator import FramewiseOscControls

    kernel, args = case['kernel'], cs.to_card(case['args'])
    if kernel == 'K9':
        from ddsp_piano_torch.kernels import voice_allocator as va

        fn = lambda: va.allocate_cuda(*args)
        want = va.allocate_plain(*case['args'])
        exact = torch.equal(fn().cpu().view(torch.int32),
                            want.view(torch.int32))
        return fn, (0.0 if exact else float('inf')), 0.0
    if kernel == 'K2':
        fn = lambda: kgru.gru_scan_cuda(*args)
        with torch.inference_mode():
            err = (fn() - kgru.gru_scan_plain(*args)).abs().max().item()
        return fn, err, cs.GRU_TOL
    if kernel == 'K5':
        fn = lambda: kgru.gru_scan_bwd_cuda(*args)
        err = max(peak_share(a, w) for a, w in zip(
            fn(), kgru.gru_scan_plain_bwd(*args)))
        return fn, err, cs.GRU_BWD_TOL
    if kernel == 'K1':
        controls, up, sr = args
        controls = FramewiseOscControls(*controls)
        fn = lambda: kosc.render_framewise_skip_cuda(controls, up, sr)
        with torch.inference_mode():
            err = peak_share(fn(), kosc.render_framewise_plain(
                controls, up, sr))
        return fn, err, cs.OSC_TOL
    if kernel == 'K4':
        controls, g, up, sr = args
        controls = FramewiseOscControls(*controls)
        fn = lambda: kosc.render_framewise_skip_bwd_cuda(controls, g, up, sr)
        err = max(peak_share(a, w) for a, w in zip(
            fn(), kosc.render_framewise_vjp_plain(controls, g, up, sr)))
        return fn, err, cs.OSC_BWD_TOL
    if kernel == 'K8':
        controls, up, sr = args
        controls = FramewiseOscControls(*controls)
        fn = lambda: kosc.render_framewise_full_cuda(controls, up, sr)
        with torch.inference_mode():
            got = fn()
            err = peak_share(got, kosc.render_framewise_full_plain(
                controls, up, sr))
            cross = peak_share(got, kosc.render_framewise_skip_cuda(
                controls, up, sr))
        if not cross <= cs.K8_K1_TOL:
            cs.fail(f"{case['name']}: K8 differs from K1 by {cross} of peak "
                    f"> {cs.K8_K1_TOL}")
        return fn, err, cs.OSC_TOL
    cuda, plain = {
        'K3': (knr.note_release_scan_cuda, knr.note_release_scan_plain),
        'K6': (knr.note_release_scan_res_cuda,
               knr.note_release_scan_plain_res),
        'K7': (knr.note_release_scan_bwd_cuda,
               knr.note_release_scan_plain_bwd)}[kernel]
    fn = lambda: cuda(*args)
    exact = all(torch.equal(a, w) for a, w in zip(fn(), plain(*args)))
    return fn, (0.0 if exact else float('inf')), 0.0


def import_checkout(root):
    """Import ddsp_piano_torch from ``root``, ahead of this script's
    directory on the path."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import ddsp_piano_torch

    found = os.path.dirname(os.path.dirname(os.path.abspath(
        ddsp_piano_torch.__file__)))
    if found != root:
        cs.fail(f"ddsp_piano_torch came from {found}, not {root}")
    from ddsp_piano_torch.device import set_f32_precision
    from ddsp_piano_torch.kernels import build

    set_f32_precision()
    return root, build, build.build_all()


def digest(out):
    """sha256 of a kernel output's bytes (a tensor or a tuple of them)."""
    import hashlib

    h = hashlib.sha256()
    for t in (out if isinstance(out, (tuple, list)) else (out,)):
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def arm(root, index):
    """Check and time this process's checkout, ``root``."""
    root, build, reports = import_checkout(root)
    rows, kernels = [], set()
    for case in torch.load(INPUTS):
        fn, err, tol = case_call(case)
        if not (np.isfinite(err) and err <= tol):
            cs.fail(f"{root}: {case['name']} differs from its plain version "
                    f"by {err} > {tol}")
        with torch.inference_mode():
            out_digest = digest(fn())
        call = cs.event_times(fn)
        device = cs.card_times(fn)
        rows.append(dict(name=case['name'], err=err, call=spread(call),
                         device=spread(device), digest=out_digest))
        kernels.add(case['kernel'])
        torch.cuda.empty_cache()
    sass = {k: sass_counts(build, *KERNELS[k], dump=os.path.join(
        OUT, f'sass_arm{index}_{k}.txt')) for k in sorted(kernels)}
    # A checkout whose build keeps no report (before build_report) gives
    # only what this process built.
    report = getattr(build, 'build_report', lambda name: '')
    ptxas = {k: ptxas_text(reports.get(KERNELS[k][0])
                           or report(KERNELS[k][0]), KERNELS[k][1])
             for k in sorted(kernels)}
    return dict(root=root, rows=rows, sass=sass, ptxas=ptxas,
                spin_mhz=cs.spin_clock_mhz())


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
    parser.add_argument('--kernels', default=','.join(KERNELS),
                        help="comma-separated kernels to compare (default "
                        "%(default)s)")
    parser.add_argument('--record', action='store_true',
                        help=argparse.SUPPRESS)
    parser.add_argument('--arm', help=argparse.SUPPRESS)
    parser.add_argument('--index', type=int, default=0,
                        help=argparse.SUPPRESS)
    args = parser.parse_args()
    kernels = set(args.kernels.split(','))
    if not kernels <= set(KERNELS):
        cs.fail(f"--kernels {args.kernels}: not among {sorted(KERNELS)}")
    if not torch.cuda.is_available():
        cs.fail("no CUDA device: this A/B needs one NVIDIA GPU")
    if args.record:
        print(json.dumps(record(kernels)))
        return
    if args.arm:
        print(json.dumps(arm(args.arm, args.index)))
        return
    card = cs.card_line()
    print(card, flush=True)
    flags = ['--kernels', args.kernels]
    other = os.path.abspath(args.other or '')
    if not os.path.isfile(os.path.join(other, 'ddsp_piano_torch', 'kernels',
                                       'oscillator.py')):
        cs.fail(f"--other {args.other!r} is no checkout of ddsp_piano_torch")

    cases = child(['--record'] + flags, 'recording the inputs')
    for case in cases:
        print(f"input {case['name']}: {case['cells']}", flush=True)
    arms = []
    for index, (label, root) in enumerate(
            (('other', other), ('this', cs.ROOT), ('this', cs.ROOT),
             ('other', other))):
        result = child(['--arm', root, '--index', str(index)] + flags,
                       f"the {label} arm ({root})")
        result['label'] = label
        arms.append(result)
        for row in result['rows']:
            print(f"{label} ({root}) {row['name']}: err {row['err']:.3g}; "
                  f"call {ms_text(row['call'])}; card "
                  f"{ms_text(row['device'])}", flush=True)
        print(f"{label} SM clock of a one-block spin (torch.cuda._sleep): "
              f"{result['spin_mhz']:.0f} MHz", flush=True)
        for kernel, lines in result['ptxas'].items():
            for line in lines:
                print(f"{label} ptxas {kernel} {line}", flush=True)
        for kernel, instances in result['sass'].items():
            for head, c in instances.items():
                loops = c.pop('loops')
                print(f"{label} SASS {kernel} {head}: " + ', '.join(
                    f"{k} {v}" for k, v in c.items()), flush=True)
                for loop in loops:
                    print(f"{label} SASS {kernel} loop " + ', '.join(
                        f"{k} {v}" for k, v in loop.items()), flush=True)
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
        digests = {a['rows'][i]['digest'] for a in arms}
        parts.append("outputs bit-equal in the four arms" if len(digests) == 1
                     else f"outputs differ: {len(digests)} digests")
        print(f"A/B {case['name']}: " + '; '.join(parts), flush=True)
        if len(digests) != 1 and case['name'].split()[0] in BIT_EQUAL_ARMS:
            cs.fail(f"{case['name']}: the arms' outputs differ")
    with open(os.path.join(OUT, 'result.json'), 'w') as f:
        json.dump(dict(card=card, other=other, cases=cases, arms=arms), f,
                  indent=1)
    print(json.dumps({'ok': True, 'card': card}))


if __name__ == '__main__':
    main()
