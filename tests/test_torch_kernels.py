"""The port's forward kernels against the JAX package's Pallas kernels.

On the CPU the port's front doors run each kernel's plain PyTorch version;
the JAX kernels run in Pallas interpret mode, as the JAX package's own
tests run them. The same numpy inputs go through both. The CUDA kernels
against their plain versions on the card: tests/test_torch_cuda.py.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import threadpoolctl

torch = pytest.importorskip('torch')
torch.set_num_threads(1)
# numpy's BLAS too, for the whole worker (xdist collects every file):
# threaded OpenBLAS stalls at each call's barrier on a loaded host.
threadpoolctl.threadpool_limits(1)

import jax.numpy as jnp  # noqa: E402

from ddsp_piano_torch.kernels import gru as tgru  # noqa: E402
from ddsp_piano_torch.kernels import note_release as tnr  # noqa: E402
from ddsp_piano_torch.kernels import oscillator as tosck  # noqa: E402
from ddsp_piano_torch.ops import core as tcore  # noqa: E402
from ddsp_piano_torch.ops import oscillator as tosc  # noqa: E402
from ddsp_piano_tpu.kernels import gru_pallas as gp  # noqa: E402
from ddsp_piano_tpu.kernels.oscillator_pallas import (  # noqa: E402
    render_framewise_pallas, render_framewise_pallas_skip)
from ddsp_piano_tpu.ops import oscillator as josc  # noqa: E402


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


# -- K1: oscillator -----------------------------------------------------------


def _osc_controls(sr, up, K, b, n_frames, seed):
    """Skip patterns of test_oscillator.py:169-190: a silent stretch, fully
    and partly Nyquist-masked frames."""
    rng = np.random.RandomState(seed)
    f0 = rng.uniform(20, sr * 3 / 8, (b, n_frames, 1)).astype(np.float32)
    f0[0, :n_frames // 4] = 0.0
    freqs = (f0 * np.arange(1, K + 1, dtype=np.float32)).astype(np.float32)
    amps = rng.rand(b, n_frames, K).astype(np.float32)
    amps[0, :n_frames // 4] = 0.0
    return josc.framewise_osc_controls(jnp.asarray(freqs), jnp.asarray(amps),
                                       up, sr)


OSC_CASES = [(16000, 64, 48, 3, 150),     # test_oscillator.py:175-177
             (24000, 96, 128, 2, 40)]     # the v2 widths


@pytest.mark.parametrize('sr,up,K,b,n_frames', OSC_CASES)
def test_oscillator_plain_matches_pallas_skip(sr, up, K, b, n_frames):
    controls = _osc_controls(sr, up, K, b, n_frames, seed=3)
    want = np.asarray(render_framewise_pallas_skip(controls, up, sr, True,
                                                   'poly'))
    port = tosc.FramewiseOscControls(*(_t(c) for c in controls))
    scale = np.abs(want).max()
    for trig in ('poly', 'native'):
        got = tosc.render_framewise(port, up, sr, trig=trig).numpy()
        # atol 1e-4 x peak: test_oscillator.py:190 (f32 reassociation of
        # the partial sum; poly vs native trig is ~1e-6 of peak).
        np.testing.assert_allclose(got, want, atol=1e-4 * scale,
                                   err_msg=trig)
    front = tosck.render_framewise_skip(port, up, sr).numpy()
    np.testing.assert_allclose(front, want, atol=1e-4 * scale)


def _dead_frame_controls(sr, up, K, b, n_frames, seed):
    """Frames with no active partial both ways: a voice held at
    midi_to_hz(0) with zero amplitudes (no note), and a stretch whose
    partials all lie above Nyquist with non-zero amplitudes."""
    rng = np.random.RandomState(seed)
    f0 = rng.uniform(20, sr * 3 / 8, (b, n_frames, 1)).astype(np.float32)
    f0[0, :n_frames // 4] = float(tcore.midi_to_hz(0.0))
    f0[-1, n_frames // 2:] = float(sr)
    freqs = (f0 * np.arange(1, K + 1, dtype=np.float32)).astype(np.float32)
    amps = rng.rand(b, n_frames, K).astype(np.float32) + 0.01
    amps[0, :n_frames // 4] = 0.0
    return josc.framewise_osc_controls(jnp.asarray(freqs), jnp.asarray(amps),
                                       up, sr)


@pytest.mark.parametrize('sr,up,K,b,n_frames', OSC_CASES)
def test_dead_frames_render_exact_zeros(sr, up, K, b, n_frames):
    """What K1 relies on to write a dead frame's row without computing
    it: every frame with active_partials == 0 renders exact zeros in the
    plain forward, and in the JAX kernel."""
    controls = _dead_frame_controls(sr, up, K, b, n_frames, seed=4)
    port = tosc.FramewiseOscControls(*(_t(c) for c in controls))
    dead = tosck.active_partials(port, sr) == 0
    assert int(dead[0].sum()) >= n_frames // 4 - 1
    assert int(dead[-1].sum()) >= n_frames // 2 - 1 and bool((~dead).any())
    plain = tosc.render_framewise(port, up, sr, trig='poly')
    jax_kernel = _t(render_framewise_pallas_skip(controls, up, sr, True,
                                                 'poly'))
    for audio in (plain, jax_kernel):
        frames = audio.reshape(b, n_frames, up)
        assert torch.all(frames[dead] == 0.0)
        assert torch.any(frames[~dead] != 0.0)


@pytest.mark.parametrize('sr,up,K,b,n_frames', OSC_CASES)
def test_kernel_sum_order_within_tolerance(sr, up, K, b, n_frames):
    """K1 sums a sample's partials in two accumulators, even and odd k, one
    term after another, then adds the two. That order, emulated on the plain
    version's terms, stays within the kernel's tolerance (1e-5 of peak) of
    the plain sum."""
    controls = _osc_controls(sr, up, K, b, n_frames, seed=6)
    f_lo, f_hi, a_lo, a_hi, phase0 = (_t(c) for c in controls)
    h, tri, s1, s_frac = (v[None, None, :, None]
                          for v in tosc.sample_tables(up, 'cpu'))
    df = (f_hi - f_lo)[:, :, None, :]
    phase = phase0[:, :, None, :] + (2.0 * np.pi / sr) * (
        s1 * f_lo[:, :, None, :] + df * tri)
    amp = a_lo[:, :, None, :] * (1.0 - h) + a_hi[:, :, None, :] * h
    amp = amp * ((f_lo[:, :, None, :] + df * s_frac) < sr / 2.0).float()
    x = tosc._range_reduce(phase)
    terms = amp * tosc._poly(tosc._COS6, x * x)          # (b, nf, up, K)
    acc = [torch.zeros(terms.shape[:3]), torch.zeros(terms.shape[:3])]
    for k in range(K):
        acc[k % 2] = acc[k % 2] + terms[..., k]
    out = (acc[0] + acc[1]).reshape(b, -1)
    want = tosc.render_framewise(tosc.FramewiseOscControls(
        f_lo, f_hi, a_lo, a_hi, phase0), up, sr, trig='poly')
    err = (out - want).abs().max().item()
    assert 0.0 < err <= 1e-5 * want.abs().max().item()


@pytest.mark.parametrize('up,sr', [(96, 24000), (64, 16000), (32, 8000)])
def test_cached_tables_equal_plain_tables(up, sr):
    """The kernels' per-sample table (kernels/oscillator.py osc_tables)
    holds the plain version's own sample_tables / gradient_tables bit for
    bit, is computed once per (up, sample_rate, device), and its host copy
    equals it."""
    table, host = tosck.osc_tables(up, sr, 'cpu')
    h, tri, s1, s_frac = tosc.sample_tables(up, 'cpu')
    w_alo, _, w_flo, w_fhi = tosc.gradient_tables(up, sr, 'cpu')
    assert table.shape == (7, up) and table.is_contiguous()
    for row, want in zip(table, (h, tri, s1, s_frac, w_alo, w_flo, w_fhi)):
        assert torch.equal(row.view(torch.int32), want.view(torch.int32))
    assert torch.equal(host.view(torch.int32), table.view(torch.int32))
    again = tosck.osc_tables(up, sr, torch.device('cpu'))
    assert again[0] is table and again[1] is host


def test_framewise_controls_match_jax():
    rng = np.random.RandomState(5)
    freqs = rng.uniform(20, 9000, (2, 300, 16)).astype(np.float32)
    amps = rng.rand(2, 300, 16).astype(np.float32)
    want = josc.framewise_osc_controls(jnp.asarray(freqs), jnp.asarray(amps),
                                       96, 24000)
    got = tosc.framewise_osc_controls(_t(freqs), _t(amps), 96, 24000)
    for name, g, w in zip(got._fields, got, want):
        g, w = g.numpy(), np.asarray(w)
        if name == 'phase0':
            # Phases compare modulo 2pi. The port sums in float64; JAX's
            # float32 cumsum reaches 300 * 2pi, where one ulp is 1.2e-4 rad.
            d = np.abs(np.angle(np.exp(1j * (g.astype(np.float64) - w))))
            assert d.max() < 1e-3, (name, d.max())
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


def test_active_partials_bound_covers_every_live_partial():
    """The kernel's loop bound: every partial past it is silent in the
    plain render."""
    controls = _osc_controls(16000, 64, 48, 3, 150, seed=1)
    port = tosc.FramewiseOscControls(*(_t(c) for c in controls))
    k_last = tosck.active_partials(port, 16000)
    k_idx = torch.arange(1, 49)
    dead = k_idx[None, None, :] > k_last[..., None]
    cut = tosc.FramewiseOscControls(
        port.f_lo, port.f_hi, torch.where(dead, 0.0, port.a_lo),
        torch.where(dead, 0.0, port.a_hi), port.phase0)
    full = tosc.render_framewise(port, 64, 16000, trig='poly')
    np.testing.assert_array_equal(
        tosc.render_framewise(cut, 64, 16000, trig='poly').numpy(),
        full.numpy())
    assert int(k_last[0, 0]) == 0 and int(k_last.max()) > 0


# -- K8: all-partials oscillator -------------------------------------------


def _full_controls(b, n_frames, K, n_sub, seed):
    """test_oscillator.py:14-19's controls (f0 in 50-2050 Hz, amplitude
    times a normalised distribution) with K = harmonics x n_sub substrings
    folded harmonic-major as MultiInharmonic folds them, a silent stretch
    and partials above Nyquist."""
    rng = np.random.RandomState(seed)
    n_harm = K // n_sub
    f0 = (rng.rand(b, n_frames, n_sub) * 2000.0 + 50.0).astype(np.float32)
    f0[..., 1:] *= 1.0007                          # detuned substrings
    freqs = (f0[..., None, :] * np.arange(1, n_harm + 1, dtype=np.float32)
             [:, None]).reshape(b, n_frames, K).astype(np.float32)
    dist = rng.rand(b, n_frames, K).astype(np.float32)
    amps = (rng.rand(b, n_frames, 1) * dist / dist.sum(-1, keepdims=True)
            ).astype(np.float32)
    amps[0, :n_frames // 4] = 0.0
    return josc.framewise_osc_controls(jnp.asarray(freqs), jnp.asarray(amps),
                                       64, 16000)


@pytest.mark.parametrize('b,n_frames,K,n_sub', [
    (3, 20, 8, 1),       # test_oscillator.py:155-166
    (2, 30, 192, 2),     # the dafx22 widths: 96 harmonics x 2 substrings
])
def test_oscillator_full_plain_matches_pallas(b, n_frames, K, n_sub):
    sr, up = 16000, 64
    controls = _full_controls(b, n_frames, K, n_sub, seed=K)
    want = np.asarray(render_framewise_pallas(controls, up, sr, True))
    port = tosc.FramewiseOscControls(*(_t(c) for c in controls))
    got = tosck.render_framewise_full(port, up, sr).numpy()
    assert got.shape == want.shape == (b, n_frames * up)
    if K == 8:
        # atol 1e-5: test_oscillator.py:166.
        np.testing.assert_allclose(got, want, atol=1e-5)
    else:
        # 1e-4 x peak: test_oscillator.py:190 (f32 reassociation of the
        # sum over 192 partials).
        np.testing.assert_allclose(got, want,
                                   atol=1e-4 * np.abs(want).max())
    # The same render as the skipping front door's, to the trig's and the
    # sum order's rounding.
    skip = tosck.render_framewise_skip(port, up, sr).numpy()
    np.testing.assert_allclose(skip, got, atol=1e-4 * np.abs(want).max())


# K8's launch plan: (B, n_frames, K, up) at the paths' shapes (the dafx22
# 10 s render and segment, dafx22_24khz's up = 96) and at the edges (one
# partial, frames not a multiple of a block's, up of one lane, of a
# ragged last lane row and of the most lanes, the largest K and B).
FULL_PLAN_CASES = [(16, 2625, 192, 64), (16, 750, 192, 64),
                   (16, 2625, 192, 96), (1, 37, 1, 64), (3, 5, 7, 96),
                   (2, 9, 200, 1), (1, 6, 128, 33), (1, 3, 128, 256),
                   (1, 3, 2905, 64), (65535, 1, 2, 32)]


@pytest.mark.parametrize('b,n_frames,k,up', FULL_PLAN_CASES)
def test_oscillator_full_plan_covers_every_sample_once(b, n_frames, k, up):
    """csrc/oscillator_full.cu under the plan: block (x, v) renders frames
    x * fpb + w of voice v, warp w one frame, lane j its samples j + 32 i
    (i < samples a lane); every (frame, sample) of a voice is rendered
    exactly once, and the block's shared memory (a float4 and a float a
    cell, an int a frame) fits."""
    plan = tosck.osc_full_plan(b, n_frames, k, up)
    fpb, ns = plan['frames_per_block'], plan['samples_per_lane']
    assert (fpb, plan['threads']) == (tosck.FULL_FRAMES_PER_BLOCK, 32 * fpb)
    assert plan['grid'] == (-(-n_frames // fpb), b)
    assert 32 * (ns - 1) < up <= 32 * ns <= 32 * tosck.FULL_MAX_SAMPLES_PER_LANE
    assert plan['smem_bytes'] == (16 + 4) * fpb * k + 4 * fpb \
        <= tosck.SMEM_LIMIT == 232448
    x, w, j, i = np.meshgrid(np.arange(plan['grid'][0]), np.arange(fpb),
                             np.arange(32), np.arange(ns), indexing='ij')
    frame, sample = (x * fpb + w).ravel(), (j + 32 * i).ravel()
    keep = (frame < n_frames) & (sample < up)
    seen = np.zeros((n_frames, up), np.int64)
    np.add.at(seen, (frame[keep], sample[keep]), 1)
    assert (seen == 1).all()


@pytest.mark.parametrize('b,n_frames,k,up', [
    (1, 10, 8, 0), (1, 10, 8, 257), (1, 10, 0, 64), (1, 10, 2906, 64),
    (65536, 10, 8, 64)])
def test_oscillator_full_plan_refuses_what_the_launch_refuses(b, n_frames,
                                                               k, up):
    """up outside 1..256, K < 1, shared memory over a block's 232448
    bytes, B over the grid's 65535: ValueError from the plan, which the
    CUDA front door reads before it builds or launches anything."""
    with pytest.raises(ValueError, match='oscillator_full kernel takes'):
        tosck.osc_full_plan(b, n_frames, k, up)


def _osc_cos_constants():
    """osc_cos's float32 constants, read from csrc/oscillator_common.cuh."""
    text = (Path(tosck.__file__).resolve().parents[1] / 'csrc'
            / 'oscillator_common.cuh').read_text()
    found = re.findall(r'constexpr float kOscCos(\w+) = ([-+.0-9eE]+)f;',
                       text)
    return {name: np.float32(value) for name, value in found}


def _osc_cos_emulated(x, c):
    """osc_cos's operations in float32 on the CPU: each product or sum
    rounded to float32, each fused multiply-add from the exact product (in
    long double) rounded once to float32."""
    f32, ld = np.float32, np.longdouble

    def fma(a, b, d):
        return (np.asarray(a, ld) * np.asarray(b, ld)
                + np.asarray(d, ld)).astype(f32)

    x = np.asarray(x, f32)
    u = fma(x, c['InvPi'], f32(0.5))
    shifted = (u + c['Shift']).astype(f32)
    sign = (shifted.view(np.uint32) & np.uint32(1)) << np.uint32(31)
    k = ((shifted - c['Shift']).astype(f32) - f32(0.5)).astype(f32)
    r = fma(k, -c['PiA'], x)
    r = fma(k, -c['PiB'], r)
    r = fma(k, -c['PiC'], r)
    z = (r * r).astype(f32)
    p = fma(c['S4'], z, c['S3'])
    p = fma(p, z, c['S2'])
    p = fma(p, z, c['S1'])
    s = fma(p, (r * z).astype(f32), r)
    return (s.view(np.uint32) ^ sign).view(f32)


def test_osc_cos_within_two_ulp_of_the_cosine():
    """K8's written-out cosine (oscillator_common.cuh osc_cos), emulated
    operation by operation, against the float64 cosine: within 2 ulp of
    the float32 result up to twice the range K8 uses it on, over random
    phases, the path's phases (a few hundred radians), phases on and beside
    the cosine's zeros, and small and signed-zero inputs."""
    c = _osc_cos_constants()
    assert set(c) == {'Range', 'InvPi', 'PiA', 'PiB', 'PiC', 'Shift', 'S1',
                      'S2', 'S3', 'S4'}
    top = 2.0 * float(c['Range'])
    rng = np.random.RandomState(0)
    zeros = ((np.arange(-int(top / np.pi), int(top / np.pi)) + 0.5)
             * np.pi).astype(np.float32)
    x = np.concatenate([
        rng.uniform(-top, top, 400000), rng.uniform(-400.0, 400.0, 200000),
        rng.uniform(-4.0, 4.0, 100000), zeros, np.nextafter(zeros, 0),
        np.nextafter(zeros, np.float32(np.inf)),
        [0.0, -0.0, 1e-30, 1e-8, np.pi / 2, np.pi, top]]).astype(np.float32)
    got = _osc_cos_emulated(x, c).astype(np.float64)
    want = np.cos(x.astype(np.float64))
    ulp = np.spacing(np.abs(want).astype(np.float32)).astype(np.float64)
    err = np.abs(got - want) / ulp
    assert err.max() <= 2.0, (x[np.argmax(err)], err.max())


def test_oscillator_full_front_door_refuses_gradients():
    controls = _full_controls(1, 6, 8, 1, seed=0)
    port = tosc.FramewiseOscControls(*(_t(c).requires_grad_()
                                       for c in controls))
    with pytest.raises(ValueError, match='forward-only'):
        tosck.render_framewise_full(port, 64, 16000)
    with torch.no_grad():
        assert tosck.render_framewise_full(port, 64, 16000).shape == (
            1, 6 * 64)


# -- K2: GRU ------------------------------------------------------------------


def _gru_inputs(T, B, u, seed):
    rng = np.random.RandomState(seed)
    x_proj = rng.randn(T, B, 3 * u).astype(np.float32)
    q, _ = np.linalg.qr(rng.randn(3 * u, u))
    rec = q.T.astype(np.float32)                     # orthogonal rows
    bias = (0.1 * rng.randn(3 * u)).astype(np.float32)
    h0 = (0.5 * rng.randn(B, u)).astype(np.float32)
    return x_proj, rec, bias, h0


@pytest.mark.parametrize('u', [64, 192])
def test_gru_plain_matches_pallas(u):
    x_proj, rec, bias, h0 = _gru_inputs(T=24, B=3, u=u, seed=u)
    want = np.asarray(gp.gru_scan_pallas(
        jnp.asarray(x_proj), jnp.asarray(rec), jnp.asarray(bias),
        jnp.asarray(h0), True))
    got = tgru.gru_scan(_t(x_proj), _t(rec), _t(bias), _t(h0)).numpy()
    # atol 1e-6: test_ctrl_kernels.py:100-103 (matmul summation order).
    np.testing.assert_allclose(got, want, atol=1e-6)


# -- K3: NoteRelease ----------------------------------------------------------


def _note_release_inputs(T=300, B=5, seed=3):
    """test_ctrl_kernels.py:111-129: release-heavy content, T not a
    multiple of the TPU kernel's 128-frame block, notes held past the
    threshold."""
    rng = np.random.RandomState(seed)
    x = np.zeros((T, B, 1), np.float32)
    for b in range(B):
        for s in range(0, T - 50, 60 + 10 * b):
            x[s:s + 25 + 20 * b, b, 0] = rng.randint(30, 90)
    return x


@pytest.mark.parametrize('threshold', [
    np.float32(1.1) * np.float32(250.0),   # the model's, not integral
    40.0,                                  # integral: ties at steps == thr
])
def test_note_release_plain_matches_pallas(threshold):
    x = _note_release_inputs()
    thr = np.asarray([threshold], np.float32)
    s0 = np.zeros((x.shape[1], 2), np.float32)
    s0[1] = [50.0, 3.0]
    want, want_state = gp.note_release_scan_pallas(
        jnp.asarray(x), jnp.asarray(thr), jnp.asarray(s0), True)
    got, got_state = tnr.note_release_scan(_t(x), _t(thr), _t(s0))
    # Exact: min/max/multiply on small integers and pitches.
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_state.numpy(), np.asarray(want_state))


# -- K3 / K6 / K7: the launch plan ---------------------------------------------

# Sequence lengths relative to the plan's tile and the path's own (750 a
# training segment, 2625 the 10 s render); lanes from one to past the
# step's 96, with B % 4 != 0 (padded by the wrapper) and == 0. Each length
# as (tiles, steps): tiles * tile_t + steps.
NR_PLAN_T = {'0': (0, 0), '1': (0, 1), 'tile-1': (1, -1), 'tile': (1, 0),
             'tile+1': (1, 1), '750': (0, 750), '2625': (0, 2625)}
NR_PLAN_B = [1, 6, 16, 96, 100, 160]


def _note_release_boxes(kernel, plan, t):
    """The TMA boxes of the ring's producer (csrc/note_release_ring.cuh)
    under ``plan``, in the order each block issues them: (block, walk, stage,
    stream, first step, first lane, shared destination in bytes). Tiles
    are cut from step 0; K6 walks them forward and K7 from the end."""
    lanes, tile_t = plan['lanes'], plan['tile_t']
    streams = tnr.NR_STREAMS[kernel]
    for block in range(plan['blocks']):
        for i in range(plan['tiles']):
            tile = plan['tiles'] - 1 - i if kernel == 'note_release_bwd' else i
            stage = i % plan['stages']
            for k in range(streams):
                yield (block, i, stage, k, tile * tile_t, block * lanes,
                       tnr.NR_RING_OFFSET
                       + 4 * (stage * streams + k) * tile_t * lanes)


@pytest.mark.parametrize('kernel', ['note_release', 'note_release_res',
                                    'note_release_bwd'])
@pytest.mark.parametrize('b', NR_PLAN_B)
@pytest.mark.parametrize('t', list(NR_PLAN_T))
def test_note_release_plan_covers_every_step_once(kernel, t, b):
    """The plan's tiles and lane slices cover every (step, lane) of every
    input stream exactly once, each block walking the steps in its
    kernel's order (K3 and K6 forward, K7 from the end) through the ring's stages
    in turn; the ring fits a block's shared memory; every TMA box meets the
    16-byte rule (row stride and box width) and lands on 128 bytes inside
    its stage."""
    tiles, steps = NR_PLAN_T[t]
    t = tiles * tnr.NR_TILE + steps
    plan = tnr.note_release_plan(kernel, t, b)
    streams = tnr.NR_STREAMS[kernel]
    lanes, tile_t, padded = plan['lanes'], plan['tile_t'], plan['padded_b']
    assert (lanes, tile_t, plan['stages']) == (tnr.NR_LANES, tnr.NR_TILE,
                                               tnr.NR_STAGES)
    stage_bytes = streams * tile_t * lanes * 4
    assert plan['smem_bytes'] == tnr.NR_RING_OFFSET + plan['stages'] \
        * stage_bytes <= tnr.NR_SMEM_LIMIT == 232448
    assert padded % 4 == 0 and b <= padded < b + 4
    assert plan['blocks'] * lanes >= padded > (plan['blocks'] - 1) * lanes
    assert plan['tiles'] * tile_t >= t > (plan['tiles'] - 1) * tile_t
    # The 16-byte rule: row stride (the padded lanes) and box width.
    assert (4 * padded) % 16 == 0 and (4 * lanes) % 16 == 0
    assert lanes <= 256 and tile_t <= 256
    boxes = list(_note_release_boxes(kernel, plan, t))
    assert len(boxes) == plan['blocks'] * plan['tiles'] * streams
    reverse = kernel == 'note_release_bwd'
    order = np.arange(t)[::-1] if reverse else np.arange(t)
    sign = -1 if reverse else 1
    for k in range(streams):
        seen = np.zeros((t, b), np.int64)
        walks = [dict() for _ in range(plan['blocks'])]
        for block, walk, stage, stream, t0, l0, dst in boxes:
            if stream != k:
                continue
            assert stage == walk % plan['stages']
            first = tnr.NR_RING_OFFSET + stage * stage_bytes
            assert dst % 128 == 0
            assert first <= dst and dst + 4 * tile_t * lanes \
                <= first + stage_bytes
            # The box is (tile_t, lanes); what lies past T or B is zero
            # filled and never read back.
            seen[t0:t0 + tile_t, l0:l0 + lanes] += 1
            for step in range(t0, min(t0 + tile_t, t)):
                walks[block][step] = walk
        assert (seen == 1).all(), (k, np.argwhere(seen != 1)[:5])
        for walk in walks:
            walked = sorted(walk, key=lambda s: (walk[s], sign * s))
            np.testing.assert_array_equal(walked, order)


@pytest.mark.parametrize('b', [1, 6, 96])
def test_note_release_lanes_padded_for_tma(b):
    """The wrapper's streams: a (T, B) stream of B % 4 != 0 lanes, or one
    whose data starts off 16 bytes, becomes a copy with the plan's padded
    lanes, zero beyond B; an aligned stream of whole lanes is passed as
    it is."""
    plan = tnr.note_release_plan('note_release_bwd', 70, b)
    base = torch.arange(71 * b, dtype=torch.float32).reshape(71, b)
    for a in (base[:70], base[1:]):
        got = tnr._launchable(a, plan['padded_b'], 1)
        assert got.shape == (70, plan['padded_b'])
        assert got.data_ptr() % 16 == 0
        assert torch.equal(got[:, :b], a) and not got[:, b:].any()
        state = a[:2].T.contiguous()
        got = tnr._launchable(state, plan['padded_b'], 0)
        assert got.shape == (plan['padded_b'], 2)
        assert torch.equal(got[:b], state) and not got[b:].any()
    if b % 4 == 0:
        assert tnr._launchable(base, b, 1) is base


def test_note_release_plan_refuses_what_the_source_does_not_take():
    with pytest.raises(ValueError, match='no note_release_bwd plan'):
        tnr.note_release_plan('note_release_bwd', -1, 96)
    with pytest.raises(ValueError, match='no note_release_res plan'):
        tnr.note_release_plan('note_release_res', 750, 0)
    with pytest.raises(ValueError, match='no note_release plan'):
        tnr.note_release_plan('note_release', 750, 0)


def test_cpu_front_doors_do_not_launch():
    from ddsp_piano_torch.kernels import build

    build.reset_launches()
    x = _t(_note_release_inputs(T=20, B=2))
    tnr.note_release_scan(x, _t([5.0]), torch.zeros(2, 2))
    tgru.gru_scan(*(_t(a) for a in _gru_inputs(5, 2, 8, seed=0)))
    controls = tosc.FramewiseOscControls(*(
        _t(c) for c in _full_controls(1, 6, 8, 1, seed=0)))
    tosck.render_framewise_full(controls, 64, 16000)
    tosck.render_framewise_skip(controls, 64, 16000)
    assert all(v == 0 for v in build.LAUNCHES.values())
