#!/usr/bin/env python3
"""Gate 2's sensitivity: the teacher-student soak of chip_smoke.py (phase
13) in one or more checkouts, on one NVIDIA GPU.

    python3 chip_soak_ab.py build/ab/parent build/ab/change

Each checkout (e.g. a commit unpacked with ``git archive``) runs in a child
process that imports its own chip_smoke.py and ddsp_piano_torch: it builds
the kernels, writes the teacher's mini-MAESTRO, then runs the 150-step
soak

- as it is, twice (is it deterministic?);
- from the student's weights times (1 + k 2^-22), k = 1, 2, 3 (how far does
  a rounding-level change move the ratio?);
- with the spectral loss's L1 taking torch.abs in place of
  ``ops.core.abs_``, where the checkout has it (JAX's +1 gradient at an
  exact tie, ROADMAP C.4), counting the exact zeros of the L1's
  differences in the first 10 steps.

One line each: the ratio of the mean of the last 20 losses to the first
20's, and the first four losses.
"""

import os
import subprocess
import sys

NUDGE = 2.0 ** -22


def arm(checkout):
    checkout = os.path.abspath(checkout)
    sys.path.insert(0, checkout)
    os.chdir(checkout)
    import torch

    import chip_smoke as cs
    from ddsp_piano_torch import configs
    from ddsp_piano_torch.device import set_f32_precision
    from ddsp_piano_torch.ops import core, spectral

    set_f32_precision()
    os.makedirs(cs.OUT_DIR, exist_ok=True)
    cs.build_kernels()
    cs.teacher_data()
    real_get_model = configs.get_model
    nudge = [0.0]

    def get_model(*args, **kwargs):
        model = real_get_model(*args, **kwargs)
        with torch.no_grad():
            for p in model.parameters():
                p.mul_(1.0 + nudge[0])
        return model

    configs.get_model = get_model
    zeros = []

    def counted(l1):
        def l1_counting(x):
            zeros.append(int((x == 0).sum()))
            return l1(x)
        return l1_counting

    runs = [('as is', 0, None), ('as is, again', 0, None)]
    runs += [(f'weights x (1 + {k} 2^-22)', k, None) for k in (1, 2, 3)]
    if hasattr(core, 'abs_'):
        runs += [('L1 on ops.core.abs_', 0, core.abs_),
                 ('L1 on torch.abs', 0, torch.abs)]
    for name, k, l1 in runs:
        nudge[0] = k * NUDGE
        if l1 is not None:
            # The spectral module reads core.abs_ at call time.
            spectral.core = type('core', (), dict(
                vars(core), abs_=staticmethod(counted(l1))))
        zeros.clear()
        s = cs.gate2_soak()
        spectral.core = core
        # 12 L1 calls a step: 6 FFT sizes x (magnitudes, log magnitudes).
        ties = ([sum(zeros[i:i + 12]) for i in range(0, 120, 12)]
                if l1 is not None else None)
        print(f"soak {os.path.basename(checkout)}, {name}: ratio "
              f"{s['ratio']:.4f} (first 20 {s['head']:.4f}, last 20 "
              f"{s['tail']:.4f}); losses 1-4 "
              f"{[round(float(v), 5) for v in s['losses'][:4]]}"
              + ('' if ties is None else
                 f"; exact zeros of the L1's differences in steps 1-10 "
                 f"{ties}"), flush=True)


def main():
    if len(sys.argv) == 3 and sys.argv[1] == '--arm':
        arm(sys.argv[2])
        return
    if len(sys.argv) < 2:
        sys.exit("usage: chip_soak_ab.py CHECKOUT [CHECKOUT ...]")
    for checkout in sys.argv[1:]:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               '--arm', checkout], timeout=1800)
        if proc.returncode:
            sys.exit(f"chip_soak_ab: {checkout} failed ({proc.returncode})")


if __name__ == '__main__':
    main()
