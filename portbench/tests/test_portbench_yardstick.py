"""The yardstick's counts against brute-force counts at small shapes."""

import math

import numpy as np
import torch

from portbench import yardstick
from portbench.reference.kernels import gru as rgru


def test_model_flops_of_products_and_transforms():
    a, b = torch.randn(5, 7), torch.randn(7, 3)
    x = torch.randn(4, 64)
    with yardstick.ModelFlops() as count:
        torch.matmul(a, b)
        torch.addmm(torch.zeros(3), a, b)
        torch.bmm(torch.randn(2, 5, 7), torch.randn(2, 7, 3))
        spec = torch.fft.rfft(x, dim=-1)
        torch.fft.irfft(spec, n=64, dim=-1)
        torch.fft.fft(x.to(torch.complex64), dim=-1)
    brute = 0
    for m, k, n, reps in ((5, 7, 3, 1), (5, 7, 3, 1), (5, 7, 3, 2)):
        brute += reps * sum(2 for _ in range(m * k * n))
    assert count.matmul == brute
    assert math.isclose(count.fft, 4 * (2.5 * 64 * 6) * 2 + 4 * 5 * 64 * 6)


def test_gru_operations_against_the_plain_scan():
    t, b, u = 5, 3, 8
    x = torch.randn(t, b, 3 * u)
    w, bias, h0 = torch.randn(u, 3 * u), torch.randn(3 * u), torch.zeros(b, u)
    with yardstick.ModelFlops() as count:
        rgru.gru_scan_plain(x, w, bias, h0)
    per_step_row = 2 * u * 3 * u + 3 * u + yardstick.GRU_GATE_FLOPS_PER_UNIT * u
    assert count.matmul == t * b * 2 * u * 3 * u
    nbytes = 4 * (t * b * 3 * u + t * b * u + u * 3 * u + 3 * u + b * u)
    assert yardstick.gru_seconds(t, b, u) == max(
        t * b * per_step_row / yardstick.PEAK_F32_FLOPS,
        nbytes / yardstick.PEAK_BYTES_PER_S)


def test_oscillator_cells_by_brute_force():
    rng = np.random.RandomState(0)
    shape = (3, 6, 5)
    f_lo = rng.uniform(0, 16000, shape).astype(np.float32)
    f_hi = rng.uniform(0, 16000, shape).astype(np.float32)
    a_lo = np.where(rng.rand(*shape) < 0.4, 0, rng.rand(*shape)).astype(
        np.float32)
    a_hi = np.where(rng.rand(*shape) < 0.4, 0, rng.rand(*shape)).astype(
        np.float32)
    controls = [torch.from_numpy(c) for c in (f_lo, f_hi, a_lo, a_hi)]
    cells = yardstick.osc_cells(controls, 24000)
    live = silent = 0
    for i in np.ndindex(*shape):
        if min(f_lo[i], f_hi[i]) < 12000:
            if a_lo[i] == 0 and a_hi[i] == 0:
                silent += 1
            else:
                live += 1
    assert cells == {'live': live, 'silent': silent}
    up = 4
    want = max(yardstick.OSC_FLOPS_PER_TERM * live * up
               / yardstick.PEAK_F32_FLOPS,
               4 * (5 * 90 + 18 * up) / yardstick.PEAK_BYTES_PER_S)
    assert yardstick.osc_seconds(3, 6, 5, up, live) == want
