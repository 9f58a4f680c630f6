"""The CUDA kernels against their plain PyTorch versions, on the card.

K1-K3 and K8 (forward), K4-K7 (gradients), K9 (the voice allocator) and
K10-K11 (the surrogate synth's decaying partials, forward and backward),
K2's and K5's bf16 instances step by step, each with its launch
counter (K3, K6 and K7 at every edge of their shared plan; K8 at edge
shapes, and its cosine to 2 ulp), and
each autograd Function on CUDA tensors against the same Function on CPU
tensors (its plain versions). Every test here needs an NVIDIA GPU and
skips without one (a CUDA kernel has no CPU mode). This file imports no JAX, so it also runs on a machine
without it; tests/conftest.py imports JAX, so run it there as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip('torch')
torch.set_num_threads(1)

from ddsp_piano_torch.device import set_f32_precision  # noqa: E402
from ddsp_piano_torch.kernels import build  # noqa: E402
from ddsp_piano_torch.kernels import gru as tgru  # noqa: E402
from ddsp_piano_torch.kernels import note_release as tnr  # noqa: E402
from ddsp_piano_torch.kernels import oscillator as tosck  # noqa: E402
from ddsp_piano_torch.kernels import oscillator_decay as tdec  # noqa: E402
from ddsp_piano_torch.ops import oscillator as tosc  # noqa: E402


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    set_f32_precision()
    return torch.device('cuda')


def _t(x, device):
    return torch.from_numpy(np.asarray(x, np.float32)).to(device)


@pytest.mark.cuda
def test_oscillator_kernel_matches_plain(cuda_device):
    rng = np.random.RandomState(2)
    f0 = rng.uniform(20, 9000, (4, 60, 1)).astype(np.float32)
    f0[0, :20] = 0.0
    freqs = f0 * np.arange(1, 129, dtype=np.float32)
    amps = rng.rand(4, 60, 128).astype(np.float32)
    amps[0, :20] = 0.0
    controls = tosc.framewise_osc_controls(
        _t(freqs, cuda_device), _t(amps, cuda_device), 96, 24000)
    want = tosck.render_framewise_plain(controls, 96, 24000)
    got = tosck.render_framewise_skip_cuda(controls, 96, 24000)
    torch.cuda.synchronize()
    # The phase, crossfade, frequency and range reduction round as the
    # plain version's; the polynomial and the accumulation round once per
    # multiply-add, and the sum over 128 partials runs in another order:
    # 1e-5 of peak.
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= 1e-5 * scale


# (u, B, T) for the GRU kernels: the paths' widths at the render's B = 16
# and the training step's B = 96; B that no row count divides; a single
# step; u whose k range or units the plan splits unevenly.
GRU_CASES = [
    (64, 1, 60), (64, 16, 60), (192, 16, 60), (64, 96, 60), (192, 96, 60),
    (192, 6, 60), (192, 13, 60), (64, 13, 60),
    (192, 16, 1), (64, 13, 1),
    (20, 5, 60),       # one CTA: 5 float4 chunks of k over 8 lanes
    (196, 16, 60),     # 25 units a CTA, 21 in the last
    # enstdkcl_8khz's context GRU (u = 32) and its, and the surrogate's,
    # mono GRU (u = 128), at the render's and the training step's rows.
    (32, 1, 60), (32, 6, 60), (128, 16, 60), (128, 96, 60),
]


def _gru_inputs(u, B, T, device, x_scale=1.0):
    rng = np.random.RandomState(u + B + T)
    x_proj = _t(x_scale * rng.randn(T, B, 3 * u), device)
    rec = _t(np.linalg.qr(rng.randn(3 * u, u))[0].T, device)
    bias = _t(0.1 * rng.randn(3 * u), device)
    h0 = _t(0.5 * rng.randn(B, u), device)
    g = _t(rng.randn(T, B, u), device)
    return x_proj, rec, bias, h0, g


@pytest.mark.cuda
@pytest.mark.parametrize('u,B,T', GRU_CASES)
def test_gru_kernel_matches_plain(cuda_device, u, B, T):
    x_proj, rec, bias, h0, _ = _gru_inputs(u, B, T, cuda_device)
    build.reset_launches()
    got = tgru.gru_scan_cuda(x_proj, rec, bias, h0)
    want = tgru.gru_scan_plain(x_proj, rec, bias, h0)
    torch.cuda.synchronize()
    assert build.LAUNCHES['gru_scan'] == 1
    # Dot-product summation order: 1e-5 over 60 steps.
    assert (got - want).abs().max().item() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize('u', [18, 260])
def test_gru_kernels_refuse_what_no_plan_takes(cuda_device, u):
    x_proj, rec, bias, h0, g = _gru_inputs(u, 4, 3, cuda_device)
    build.reset_launches()
    with pytest.raises(ValueError, match='no launch plan'):
        tgru.gru_scan_cuda(x_proj, rec, bias, h0)
    with pytest.raises(ValueError, match='no launch plan'):
        tgru.gru_scan_bwd_cuda(x_proj, rec, bias, h0, g[:, :, :u], g)
    assert build.LAUNCHES['gru_scan'] == build.LAUNCHES['gru_scan_bwd'] == 0


@pytest.mark.cuda
def test_note_release_kernel_bit_exact(cuda_device):
    x = np.zeros((301, 16, 1), np.float32)
    x[10:40, :, 0] = 60.0
    x[200:210, ::2, 0] = 72.0
    x = _t(x, cuda_device)
    thr = torch.tensor([275.0], device=cuda_device)
    s0 = torch.zeros(16, 2, device=cuda_device)
    build.reset_launches()
    got, got_state = tnr.note_release_scan_cuda(x, thr, s0)
    want, want_state = tnr.note_release_scan_plain(x, thr, s0)
    assert torch.equal(got, want) and torch.equal(got_state, want_state)
    assert build.LAUNCHES['note_release'] == 1


@pytest.mark.cuda
def test_oscillator_full_kernel_matches_plain(cuda_device):
    """K8 at the dafx22 widths (96 harmonics x 2 substrings, 16 kHz, 64
    samples per frame), against its plain version and against K1."""
    rng = np.random.RandomState(5)
    f0 = rng.uniform(20, 3000, (16, 80, 2)).astype(np.float32)
    f0[:, :, 1] *= 1.0005
    f0[0, :30] = 0.0
    freqs = (f0[:, :, None, :] * np.arange(1, 97, dtype=np.float32)[:, None]
             ).reshape(16, 80, 192)
    amps = rng.rand(16, 80, 192).astype(np.float32) / 96.0
    amps[0, :30] = 0.0
    controls = tosc.framewise_osc_controls(
        _t(freqs, cuda_device), _t(amps, cuda_device), 64, 16000)
    build.reset_launches()
    got = tosck.render_framewise_full_cuda(controls, 64, 16000)
    want = tosck.render_framewise_full_plain(controls, 64, 16000)
    skip = tosck.render_framewise_skip_cuda(controls, 64, 16000)
    torch.cuda.synchronize()
    assert build.LAUNCHES['oscillator_full'] == 1
    scale = want.abs().max().item()
    # The phase, crossfade, frequency and mask round as the plain version's
    # (--fmad=false); the cosine is K8's own, within 2 ulp of the cosine as
    # torch.cos is, and the sum over 192 partials runs in another order
    # with one rounding a multiply-add: 1e-5 of peak.
    assert (got - want).abs().max().item() <= 1e-5 * scale
    # K1: polynomial against native trig, another order: 1e-4 of peak.
    assert (skip - got).abs().max().item() <= 1e-4 * scale


def _full_edge_controls(up, K, n_frames, device, phase_shift=None,
                        f0_max=None):
    """Controls at the frame rate of 250 Hz (sample rate 250 up) with K
    partials, four voices: f0 random up to ``f0_max`` (Nyquist by default,
    so that high partials cross it within a frame); the same with frames
    whose f0 puts a partial exactly on Nyquist (at or above it: silent); a
    silent voice; a voice whose partials all stay below Nyquist. Then
    ``phase_shift`` (4, n_frames) is added to phase0. K8 walks frames of
    the first kind with its Nyquist test, of the last without."""
    sr = 250 * up
    rng = np.random.RandomState(up + K)
    b = 4
    f0 = rng.uniform(20.0, f0_max or sr / 2.0, (b, n_frames, 1))
    f0[1, ::3] = (sr / 2.0) / rng.randint(1, K + 1, (n_frames + 2) // 3)[
        :, None]
    f0[3] = rng.uniform(20.0, sr / (2.0 * (K + 1)), (n_frames, 1))
    freqs = f0 * np.arange(1, K + 1)
    amps = rng.rand(b, n_frames, K) / K
    amps[2] = 0.0
    controls = tosc.framewise_osc_controls(_t(freqs, device),
                                           _t(amps, device), up, sr)
    if phase_shift is not None:
        controls = controls._replace(
            phase0=controls.phase0 + _t(phase_shift, device)[..., None])
    return controls, sr


@pytest.mark.cuda
@pytest.mark.parametrize('K', [1, 7, 128, 192, 200])
@pytest.mark.parametrize('up', [64, 96])
def test_oscillator_full_kernel_at_edge_shapes(cuda_device, up, K):
    """K8 against its plain version (1e-5 of peak) and against K1 (1e-4 of
    peak) at one partial, an odd count, the paths' 128 and 192 and more
    than a lane's multiple; 37 frames, not a multiple of a block's 4;
    partials at, above and crossing Nyquist; a silent voice; a voice wholly
    below Nyquist."""
    controls, sr = _full_edge_controls(up, K, 37, cuda_device)
    build.reset_launches()
    got = tosck.render_framewise_full_cuda(controls, up, sr)
    assert build.LAUNCHES['oscillator_full'] == 1
    want = tosck.render_framewise_full_plain(controls, up, sr)
    skip = tosck.render_framewise_skip_cuda(controls, up, sr)
    torch.cuda.synchronize()
    scale = want.abs().max().item()
    assert got.shape == want.shape == (4, 37 * up)
    assert (got - want).abs().max().item() <= 1e-5 * scale
    assert (skip - got).abs().max().item() <= 1e-4 * scale
    assert torch.all(got[2] == 0.0)


@pytest.mark.cuda
def test_oscillator_full_cosine_within_two_ulp(cuda_device):
    """K8's cosine on the card: one partial at 0 Hz of amplitude 1 and one
    sample a frame render cos(phase0) itself. Within 2 ulp of the float64
    cosine for phases of the path's size, on and beside the cosine's zeros,
    and up to 1.5 times the written-out cosine's range, where frames take
    cosf (tests/test_torch_kernels.py holds the same operations emulated on
    the CPU)."""
    rng = np.random.RandomState(11)
    zeros = (np.arange(-30000, 30000) + 0.5) * np.pi
    x = np.concatenate([
        rng.uniform(-400.0, 400.0, 100000), rng.uniform(-1.5e5, 1.5e5, 200000),
        zeros, np.nextafter(zeros.astype(np.float32), np.float32(0)),
        [0.0, 1e-30, np.pi / 2, 99999.0, 1e5, 100001.0]]).astype(np.float32)
    n = x.size
    zero = torch.zeros((1, n, 1), device=cuda_device)
    one = torch.ones((1, n, 1), device=cuda_device)
    controls = tosc.FramewiseOscControls(zero, zero, one, one,
                                         _t(x, cuda_device)[None, :, None])
    got = tosck.render_framewise_full_cuda(controls, 1, 16000)
    got = got[0].double().cpu().numpy()
    want = np.cos(x.astype(np.float64))
    ulp = np.spacing(np.abs(want).astype(np.float32)).astype(np.float64)
    err = np.abs(got - want) / ulp
    assert err.max() <= 2.0, (x[np.argmax(err)], err.max())


@pytest.mark.cuda
def test_oscillator_full_kernel_near_and_above_the_cosine_range(
        cuda_device):
    """Phases near the written-out cosine's range (1e5 rad) and above it:
    frames whose phases stay below it take the written-out cosine, frames
    that reach it take cosf; both within 1e-5 of peak of the plain
    version. f0 below 100 Hz keeps 192 partials' phase advance in a frame
    under ~500 rad."""
    n_frames = 40
    shift = np.zeros((4, n_frames), np.float32)
    shift[:, 0::4] = 9.9e4             # the phases stay below 1e5
    shift[:, 1::4] = 1.0e5             # at the range: cosf
    shift[:, 2::4] = -1.2e5            # above it
    controls, sr = _full_edge_controls(64, 192, n_frames, cuda_device, shift,
                                       f0_max=100.0)
    got = tosck.render_framewise_full_cuda(controls, 64, sr)
    want = tosck.render_framewise_full_plain(controls, 64, sr)
    torch.cuda.synchronize()
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= 1e-5 * scale


def _osc_controls(device, b=4, n_frames=60, seed=2):
    rng = np.random.RandomState(seed)
    f0 = rng.uniform(20, 9000, (b, n_frames, 1)).astype(np.float32)
    f0[0, :20] = 0.0
    freqs = f0 * np.arange(1, 129, dtype=np.float32)
    amps = rng.rand(b, n_frames, 128).astype(np.float32)
    amps[0, :20] = 0.0
    return tosc.framewise_osc_controls(_t(freqs, device), _t(amps, device),
                                       96, 24000)


@pytest.mark.cuda
def test_oscillator_bwd_kernel_matches_plain(cuda_device):
    controls = _osc_controls(cuda_device)
    g = _t(np.random.RandomState(3).randn(4, 60 * 96), cuda_device)
    build.reset_launches()
    got = tosck.render_framewise_skip_bwd_cuda(controls, g, 96, 24000)
    want = tosck.render_framewise_vjp_plain(controls, g, 96, 24000)
    torch.cuda.synchronize()
    assert build.LAUNCHES['oscillator_skip_bwd'] == 1
    for name, a, w in zip(controls._fields, got, want):
        # The phase, mask, crossfade and range reduction round as the plain
        # VJP's; the polynomials and the five sums round once per
        # multiply-add, and the 96-sample sums run in another order: 1e-5
        # of each gradient's peak.
        scale = w.abs().max().item()
        assert (a - w).abs().max().item() <= 1e-5 * scale, name


# midi_to_hz(0): the f0 the model holds for a voice with no note.
_SILENT_F0 = 440.0 * 2.0 ** (-69.0 / 12.0)


def _osc_batch(kind, up, sr, K, B, n_frames, device):
    """Controls for K1 and K4 at (B, n_frames, K): 'silent', every voice
    held at midi_to_hz(0) with zero amplitudes; 'sounding', every partial
    below Nyquist live; 'mixed', silent and sounding voices, frames whose
    warps mix silent and sounding partials (partials 8-19 silent), frames
    whose last active partial is 45 (not a multiple of any slice count
    but 1, 3, 5, 9, 15, 45) and a stretch wholly above Nyquist."""
    rng = np.random.RandomState(up + K + B)
    f0 = rng.uniform(20.0, sr / (2.5 * K), (B, n_frames, 1))
    amps = rng.rand(B, n_frames, K) + 0.01
    if kind in ('silent', 'mixed'):
        silent = slice(None) if kind == 'silent' else slice(0, B, 2)
        f0[silent] = _SILENT_F0
        amps[silent] = 0.0
    if kind == 'mixed':
        amps[1::2, 5:15, 8:20] = 0.0
        amps[1::2, 20:30, 45:] = 0.0
        f0[-1, n_frames - 6:] = sr
        f0[1::4] *= 3.0                       # some partials above Nyquist
    freqs = f0 * np.arange(1, K + 1)
    controls = tosc.framewise_osc_controls(_t(freqs, device),
                                           _t(amps, device), up, sr)
    g = _t(rng.randn(B, n_frames * up), device)
    return controls, g


# (up, sample rate, K): v2 and dafx22_24khz (96), dafx22 (64, 2 x 96
# harmonics), a generic up that takes no unrolled instance, and the
# ENSTDkCl models' (32 with 48 partials, 128 with 192), which take K4's
# generic kernel too.
OSC_RATES = [(96, 24000, 128), (64, 16000, 192), (32, 8000, 40),
             (32, 8000, 48), (128, 32000, 192)]


@pytest.mark.cuda
@pytest.mark.parametrize('kind', ['silent', 'sounding', 'mixed'])
@pytest.mark.parametrize('up,sr,K', OSC_RATES)
def test_oscillator_kernels_match_plain_by_cell_kind(cuda_device, up, sr,
                                                     K, kind):
    _check_oscillator_pair(*_osc_batch(kind, up, sr, K, 6, 40, cuda_device),
                           up, sr)


@pytest.mark.cuda
def test_oscillator_kernels_match_plain_at_the_training_step_rows(
        cuda_device):
    """The training step's B = 96 voice rows (batch 6 x 16 voices)."""
    _check_oscillator_pair(*_osc_batch('mixed', 96, 24000, 128, 96, 24,
                                       cuda_device), 96, 24000)


def _check_oscillator_pair(controls, g, up, sr):
    """K1 and K4 against their plain versions (1e-5 of peak, as in the
    tests above; an all-zero plain result must be matched exactly), each
    launch counter moving once a call, and the silent cells' d f_lo, d f_hi
    and d phase0 exactly 0."""
    build.reset_launches()
    got = tosck.render_framewise_skip_cuda(controls, up, sr)
    assert build.LAUNCHES['oscillator_skip'] == 1
    grads = tosck.render_framewise_skip_bwd_cuda(controls, g, up, sr)
    assert build.LAUNCHES['oscillator_skip_bwd'] == 1
    want = tosck.render_framewise_plain(controls, up, sr)
    want_grads = tosck.render_framewise_vjp_plain(controls, g, up, sr)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()
    for name, a, w in zip(controls._fields, grads, want_grads):
        assert (a - w).abs().max().item() <= 1e-5 * w.abs().max().item(), name
    f_lo, f_hi, a_lo, a_hi, _ = controls
    silent = ((torch.minimum(f_lo, f_hi) < sr / 2.0) & (a_lo == 0.0)
              & (a_hi == 0.0))
    for d in (grads.f_lo, grads.f_hi, grads.phase0):
        assert torch.all(d[silent] == 0.0)
    assert sum(v for v in build.LAUNCHES.values()) == 2


@pytest.mark.cuda
@pytest.mark.parametrize('u,B,T', GRU_CASES)
def test_gru_bwd_kernel_matches_plain(cuda_device, u, B, T):
    x_proj, rec, bias, h0, g = _gru_inputs(u, B, T, cuda_device, 0.5)
    hs = tgru.gru_scan_plain(x_proj, rec, bias, h0)
    build.reset_launches()
    got = tgru.gru_scan_bwd_cuda(x_proj, rec, bias, h0, hs, g)
    want = tgru.gru_scan_plain_bwd(x_proj, rec, bias, h0, hs, g)
    torch.cuda.synchronize()
    assert build.LAUNCHES['gru_scan_bwd'] == 1
    for name, a, w in zip(('dxz', 'dxr', 'dxh', 'drh', 'dh0'), got, want):
        # expf/tanhf and dot-product order over 60 steps: 1e-5 of each
        # stream's peak.
        assert (a - w).abs().max().item() <= 1e-5 * max(
            1.0, w.abs().max().item()), name


# The bf16 instances of K2 and K5 (nn.layers.enable_bf16_control): the
# paths' widths and rows, one CTA, one step.
GRU_BF16_CASES = [(64, 1, 60), (64, 6, 60), (192, 16, 60), (192, 96, 60),
                  (20, 5, 60), (192, 16, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize('u,B,T', GRU_BF16_CASES)
def test_gru_bf16_kernels_match_plain_step_by_step(cuda_device, u, B, T):
    x_proj, rec, bias, h0, g = _gru_inputs(u, B, T, cuda_device, 0.5)
    build.reset_launches()
    hs = tgru.gru_scan_cuda(x_proj, rec, bias, h0, True)
    streams = tgru.gru_scan_bwd_cuda(x_proj, rec, bias, h0, hs, g, True)
    torch.cuda.synchronize()
    for kernel in ('gru_scan', 'gru_scan_bwd'):
        assert build.LAUNCHES[kernel] == build.BF16_LAUNCHES[kernel] == 1
    # Each step against the bf16 plain version's step from the kernel's
    # own earlier ones (a whole run drifts further, as the plain version
    # does between the card and the CPU: a state an ulp apart rounds to
    # bf16 values 2^-8 apart now and then).
    want = tgru.gru_scan_plain_steps(x_proj, rec, bias, h0, hs, True)
    assert (hs - want).abs().max().item() <= 1e-5
    want = tgru.gru_scan_plain_bwd_steps(x_proj, rec, bias, h0, hs, g,
                                         streams, True)
    for name, a, w in zip(('dxz', 'dxr', 'dxh', 'drh', 'dh0'), streams,
                          want):
        assert (a - w).abs().max().item() <= 1e-5 * max(
            1.0, w.abs().max().item()), name
    # The float32 instance's steps are not the bf16 plain version's.
    f32 = tgru.gru_scan_cuda(x_proj, rec, bias, h0)
    assert (f32 - tgru.gru_scan_plain_steps(
        x_proj, rec, bias, h0, f32, True)).abs().max().item() > 1e-4


@pytest.mark.cuda
def test_note_release_res_and_bwd_kernels_bit_exact(cuda_device):
    x = np.zeros((700, 16, 1), np.float32)
    x[10:60, :, 0] = 60.0
    x[400:430, ::2, 0] = 48.0
    x[5:40, 1, 0] = 1.0
    x = _t(x, cuda_device)
    thr = torch.tensor([275.0], device=cuda_device)   # integral: ties
    s0 = torch.zeros(16, 2, device=cuda_device)
    s0[3] = torch.tensor([50.0, 270.0])
    rng = np.random.RandomState(4)
    g_out = _t(rng.randn(700, 16, 1), cuda_device)
    g_state = _t(rng.randn(16, 2), cuda_device)
    build.reset_launches()
    got = tnr.note_release_scan_res_cuda(x, thr, s0)
    want = tnr.note_release_scan_plain_res(x, thr, s0)
    assert all(torch.equal(a, w) for a, w in zip(got, want))
    u = want[2] - 275.0
    assert bool((u == 0).any()) and bool((u == 1).any())
    prev = torch.cat([s0[None, :, 0], want[0][:-1, :, 0]], dim=0)
    got = tnr.note_release_scan_bwd_cuda(x, thr, prev, want[2], g_out,
                                         g_state)
    want = tnr.note_release_scan_plain_bwd(x, thr, prev, want[2], g_out,
                                           g_state)
    assert all(torch.equal(a, w) for a, w in zip(got, want))
    assert build.LAUNCHES['note_release_res'] == 1
    assert build.LAUNCHES['note_release_bwd'] == 1


# Lengths as (tiles, steps) of the plan's tile, and lanes, as in
# tests/test_torch_kernels.py's plan tests.
NR_PLAN_T = {'0': (0, 0), '1': (0, 1), 'tile-1': (1, -1), 'tile': (1, 0),
             'tile+1': (1, 1), '750': (0, 750), '2625': (0, 2625)}


@pytest.mark.cuda
@pytest.mark.parametrize('b', [1, 6, 16, 96, 100, 160])
@pytest.mark.parametrize('t', list(NR_PLAN_T))
def test_note_release_pair_bit_exact_at_plan_edges(cuda_device, t, b):
    """K6 and K7 against their plain pair at every edge of the launch plan
    (no tile, one step, a ragged tile on either side of a whole one, the
    path's lengths; one lane to past the step's 96, with and without lanes
    padded to a multiple of 4), with release ties: chip_smoke.py's edge
    inputs, an integral threshold and initial release counts on it and one
    below, so steps - thr lands on 0 and 1."""
    from chip_smoke import note_release_edge_inputs

    tiles, steps = NR_PLAN_T[t]
    t = tiles * tnr.NR_TILE + steps
    x, thr, s0, g_out, g_state = note_release_edge_inputs(
        t, b, seed=t * 1000 + b, device=cuda_device)
    build.reset_launches()
    got = tnr.note_release_scan_res_cuda(x, thr, s0)
    want = tnr.note_release_scan_plain_res(x, thr, s0)
    assert all(torch.equal(a, w) for a, w in zip(got, want))
    if t >= 2:
        u = want[2] - 5.0
        assert bool((u == 0).any()) and bool((u == 1).any())
    prev = torch.cat([s0[None, :, 0], want[0][:-1, :, 0]], dim=0)[:t]
    got = tnr.note_release_scan_bwd_cuda(x, thr, prev, want[2], g_out,
                                         g_state)
    want = tnr.note_release_scan_plain_bwd(x, thr, prev, want[2], g_out,
                                           g_state)
    assert all(torch.equal(a, w) for a, w in zip(got, want))
    assert build.LAUNCHES['note_release_res'] == 1
    assert build.LAUNCHES['note_release_bwd'] == 1


@pytest.mark.cuda
@pytest.mark.parametrize('b', [1, 6, 16, 96, 100, 160])
@pytest.mark.parametrize('t', list(NR_PLAN_T))
def test_note_release_kernel_bit_exact_at_plan_edges(cuda_device, t, b):
    """K3, which walks K6's ring under the same plan, against its plain
    version at every edge of the plan, with release ties (the inputs of
    test_note_release_pair_bit_exact_at_plan_edges)."""
    from chip_smoke import note_release_edge_inputs

    tiles, steps = NR_PLAN_T[t]
    t = tiles * tnr.NR_TILE + steps
    x, thr, s0, _, _ = note_release_edge_inputs(t, b, seed=t * 1000 + b,
                                                device=cuda_device)
    build.reset_launches()
    got = tnr.note_release_scan_cuda(x, thr, s0)
    want = tnr.note_release_scan_plain(x, thr, s0)
    assert all(torch.equal(a, w) for a, w in zip(got, want))
    assert build.LAUNCHES['note_release'] == 1
    if t >= 2:
        u = tnr.note_release_scan_plain_res(x, thr, s0)[2] - 5.0
        assert bool((u == 0).any()) and bool((u == 1).any())


def _both_devices(arrays, device):
    cpu = [torch.from_numpy(np.asarray(a, np.float32)).requires_grad_()
           for a in arrays]
    gpu = [a.detach().to(device).requires_grad_() for a in cpu]
    return cpu, gpu


def _assert_function_agrees(fn, arrays, cotangents, device, tol):
    """fn's outputs and input gradients on CUDA (the kernels) against the
    CPU (the plain versions); tol is a share of each tensor's peak."""
    cpu, gpu = _both_devices(arrays, device)
    outs = []
    for inputs in (cpu, gpu):
        out = fn(*inputs)
        out = out if isinstance(out, tuple) else (out,)
        cts = [torch.from_numpy(np.asarray(c, np.float32)).to(o.device)
               for c, o in zip(cotangents, out)]
        grads = torch.autograd.grad(out, inputs, cts)
        outs.append([o.detach().cpu() for o in out + grads])
    for i, (a, w) in enumerate(zip(outs[1], outs[0])):
        err = (a - w).abs().max().item()
        assert err <= tol * max(w.abs().max().item(), 1e-6), (i, err)


@pytest.mark.cuda
def test_functions_on_cuda_match_cpu(cuda_device):
    rng = np.random.RandomState(9)
    # NoteRelease: K6 + K7 against the plain pair: bit for bit but for the
    # threshold gradient's sum over lanes, taken in two orders (1e-6).
    x = np.zeros((300, 8, 1), np.float32)
    x[5:60, :, 0] = 64.0
    _assert_function_agrees(
        tnr.note_release_scan, [x, [40.0], np.zeros((8, 2))],
        [rng.randn(300, 8, 1), rng.randn(8, 2)], cuda_device, 1e-6)
    # GRU: K2 + K5 (then the weight contractions) against the plain pair.
    u, B, T = 64, 4, 40
    _assert_function_agrees(
        tgru.gru_scan,
        [0.5 * rng.randn(T, B, 3 * u), 0.3 * rng.randn(u, 3 * u),
         0.1 * rng.randn(3 * u), 0.5 * rng.randn(B, u)],
        [rng.randn(T, B, u)], cuda_device, 1e-5)
    # Oscillator: K1 + K4 against the plain pair.
    controls = _osc_controls('cpu', b=2, n_frames=20)
    _assert_function_agrees(
        lambda *c: tosck.render_framewise_skip(
            tosc.FramewiseOscControls(*c), 96, 24000),
        [c.numpy() for c in controls], [rng.randn(2, 20 * 96)],
        cuda_device, 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize('wire', [True, False], ids=['packed', 'packed32'])
def test_packed_staging_decodes_bit_exactly_on_the_card(cuda_device, wire):
    """BatchPacker's lanes decoded on the card equal the batch bit for bit
    (the i16 scales divide, as the host check does; a division by a
    Python scalar would multiply by its reciprocal)."""
    from ddsp_piano_torch.data.pipeline import get_dummy_data
    from ddsp_piano_torch.training.staging import BatchPacker

    rng = np.random.RandomState(0)
    batch = dict(get_dummy_data(2, 0.5, 24000),
                 audio=(rng.randint(-32768, 32768, (2, 12000)) / 32768.0
                        ).astype(np.float32),
                 conditioning=(rng.randint(0, 128, (2, 125, 16, 2)) / 127.0
                               ).astype(np.float32))
    packer = BatchPacker(batch, wire=wire)
    if wire:
        assert packer.encodings()['audio'] == 'i16x32768'
        assert packer.encodings()['conditioning'] == 'i16x127'
    lanes = torch.from_numpy(packer.pack(batch).view(np.int16))
    got = packer.unpack(lanes.to(cuda_device))
    for k, v in batch.items():
        assert got[k].is_cuda
        np.testing.assert_array_equal(got[k].cpu().numpy(), v, err_msg=k)


def _voice_allocator_case(case, n, device):
    """(pitches, velocity) at n voices on ``device``: 'rolls', three
    120-frame rolls within and over capacity, one with non-binary active
    values (key * active collisions, the overflow clamp); 'long_held',
    two 2625-frame rolls of 20 notes (demo.mid's 10 s and its density:
    long runs the walk skips); 'odd', unsorted frames with repeated
    pitches, 0.0, -0.0 and NaN; 'T1' and 'T33' of those at 1 and 33
    frames."""
    from ddsp_piano_torch.data.midi_encoders_device import top_voices
    from ddsp_piano_torch.data.rolls import held_notes_roll, odd_voices

    if case == 'rolls':
        rolls = np.stack([held_notes_roll(s, 120, d)
                          for s, d in ((1, 20), (2, 90), (3, 60))])
        rolls[2, :, :, 0] *= np.random.RandomState(4).choice(
            np.float32([0.5, 1.0, 2.0, 3.0]), size=(120, 88))
    elif case == 'long_held':
        rolls = np.stack([held_notes_roll(s, 2625, 20) for s in (5, 6)])
    else:
        frames = {'odd': 500, 'T1': 1, 'T33': 33}[case]
        return tuple(torch.from_numpy(a).to(device)
                     for a in odd_voices(n, 3, frames, n))
    return top_voices(torch.from_numpy(rolls).to(device), n)


@pytest.mark.cuda
@pytest.mark.parametrize('case', ['rolls', 'long_held', 'odd', 'T1', 'T33'])
@pytest.mark.parametrize('n', [1, 4, 16, 32])
def test_voice_allocator_kernel_matches_plain(cuda_device, n, case):
    """K9 against the plain loop (run on the host), bit for bit (NaN
    payloads and signed zeros included), at 1 to 32 voices on each case
    of _voice_allocator_case; one count for its three kernels."""
    from ddsp_piano_torch.kernels import voice_allocator as tva

    pitches, velocity = _voice_allocator_case(case, n, cuda_device)
    build.reset_launches()
    got = tva.allocate(pitches, velocity)
    torch.cuda.synchronize()
    assert build.LAUNCHES['voice_allocator'] == 1
    want = tva.allocate_plain(pitches.cpu(), velocity.cpu())
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


def _other_card_case(kernel, device):
    """(wrapper call, plain call, tolerance kind) of one kernel at small
    inputs on ``device``."""
    if kernel in ('oscillator_skip', 'oscillator_skip_bwd'):
        controls = _osc_controls(device)
        g = _t(np.random.RandomState(3).randn(4, 60 * 96), device)
        if kernel == 'oscillator_skip':
            return (lambda: tosck.render_framewise_skip_cuda(controls, 96,
                                                             24000),
                    lambda: tosck.render_framewise_plain(controls, 96, 24000),
                    'peak')
        return (lambda: tosck.render_framewise_skip_bwd_cuda(controls, g, 96,
                                                             24000),
                lambda: tosck.render_framewise_vjp_plain(controls, g, 96,
                                                         24000), 'peak')
    if kernel in ('oscillator_decay', 'oscillator_decay_bwd'):
        controls, decays, decay_time = _decay_inputs(device)
        if kernel == 'oscillator_decay':
            return (lambda: tdec.render_framewise_decay_cuda(
                        controls, decays, decay_time, 64, 16000),
                    lambda: tosc.render_framewise_decay(
                        controls, decays, decay_time, 64, 16000), 'peak')
        g = _t(np.random.RandomState(3).randn(4, 60 * 64), device)
        return (lambda: _flat_decay_grads(tdec.render_framewise_decay_bwd_cuda(
                    controls, decays, decay_time, g, 64, 16000)),
                lambda: _flat_decay_grads(tosc.render_framewise_decay_vjp(
                    controls, decays, decay_time, g, 64, 16000)), 'peak')
    if kernel == 'oscillator_full':
        controls, sr = _full_edge_controls(64, 96, 40, device)
        return (lambda: tosck.render_framewise_full_cuda(controls, 64, sr),
                lambda: tosck.render_framewise_full_plain(controls, 64, sr),
                'peak')
    if kernel in ('gru_scan', 'gru_scan_bwd'):
        x_proj, rec, bias, h0, g = _gru_inputs(192, 16, 60, device, 0.5)
        if kernel == 'gru_scan':
            return (lambda: tgru.gru_scan_cuda(x_proj, rec, bias, h0),
                    lambda: tgru.gru_scan_plain(x_proj, rec, bias, h0),
                    'absolute')
        hs = tgru.gru_scan_plain(x_proj, rec, bias, h0)
        return (lambda: tgru.gru_scan_bwd_cuda(x_proj, rec, bias, h0, hs, g),
                lambda: tgru.gru_scan_plain_bwd(x_proj, rec, bias, h0, hs,
                                                g), 'absolute')
    if kernel == 'voice_allocator':
        from ddsp_piano_torch.kernels import voice_allocator as tva

        pitches, velocity = _voice_allocator_case('rolls', 16, device)
        return (lambda: tva.allocate_cuda(pitches, velocity),
                lambda: tva.allocate_plain(pitches.cpu(), velocity.cpu()),
                'bits')
    x = np.zeros((301, 16, 1), np.float32)
    x[10:40, :, 0] = 60.0
    x[200:210, ::2, 0] = 72.0
    x = _t(x, device)
    thr = torch.tensor([275.0], device=device)
    s0 = torch.zeros(16, 2, device=device)
    if kernel == 'note_release':
        return (lambda: tnr.note_release_scan_cuda(x, thr, s0),
                lambda: tnr.note_release_scan_plain(x, thr, s0), 'bits')
    if kernel == 'note_release_res':
        return (lambda: tnr.note_release_scan_res_cuda(x, thr, s0),
                lambda: tnr.note_release_scan_plain_res(x, thr, s0), 'bits')
    out, _, steps = tnr.note_release_scan_plain_res(x, thr, s0)
    prev = torch.cat([s0[None, :, 0], out[:-1, :, 0]], dim=0)
    rng = np.random.RandomState(4)
    g_out, g_state = _t(rng.randn(301, 16, 1), device), _t(
        rng.randn(16, 2), device)
    return (lambda: tnr.note_release_scan_bwd_cuda(x, thr, prev, steps, g_out,
                                                   g_state),
            lambda: tnr.note_release_scan_plain_bwd(x, thr, prev, steps,
                                                    g_out, g_state), 'bits')


@pytest.mark.cuda
@pytest.mark.parametrize('card', [1, 2, 3])
@pytest.mark.parametrize('kernel', list(build.KERNELS))
def test_front_door_launches_on_its_inputs_card(cuda_device, kernel, card):
    """Each kernel's wrapper, given tensors on cuda:<card> while the
    process's current device is cuda:0, launches on their card (a rank's
    tensors in a data-parallel run) and equals its plain version there:
    the tolerances of this file's tests of each kernel (1e-5 of peak for
    the oscillators, 1e-5 for the GRU streams, bit for bit for the
    NoteRelease kernels and the voice allocator)."""
    if torch.cuda.device_count() <= card:
        pytest.skip(f"needs a card cuda:{card}")
    device = torch.device('cuda', card)
    torch.cuda.set_device(0)
    with torch.cuda.device(0):
        kernel_call, plain_call, tolerance = _other_card_case(kernel, device)
        build.reset_launches()
        got = kernel_call()
        torch.cuda.synchronize(device)
        assert torch.cuda.current_device() == 0
    assert build.LAUNCHES[kernel] == 1
    want = plain_call()
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    worst = 0.0
    for a, w in zip(got, want):
        assert a.device == device
        w = w.to(device)
        if tolerance == 'bits':
            assert torch.equal(a.view(torch.int32), w.view(torch.int32))
            continue
        err = (a - w).abs().max().item()
        scale = (w.abs().max().item() if tolerance == 'peak'
                 else max(1.0, w.abs().max().item()))
        worst = max(worst, err / scale)
        assert err <= 1e-5 * scale
    print(f"\n{kernel} on cuda:{card} from cuda:0: worst error "
          f"{worst:.3g} ({tolerance})")


def _decay_inputs(device, b=4, t=60, k=96, up=64, sr=16000):
    """Surrogate synth controls at 16 kHz: a voice silent for 20 frames
    (below min_frequency, amplitudes 0), partials past Nyquist, a voice
    whose upper half is silent, decays 1 - 10^u (u in [-5, -3]) and the
    frames since an onset at frames 0 and 30."""
    rng = np.random.RandomState(5)
    f0 = rng.uniform(30.0, 2000.0, (b, 1, 1)).repeat(t, 1)
    f0[0, :20] = 8.0
    f0[2, 40:] *= 1.3
    freqs = f0 * np.arange(1, k + 1) * (1.0 + 1e-4 * rng.rand(b, t, k))
    amps = rng.rand(b, t, k)
    amps[0, :20] = 0.0
    amps[1, :, k // 2:] = 0.0
    controls = tosc.framewise_osc_controls(_t(freqs, device),
                                           _t(amps, device), up, sr)
    decays = 1.0 - 10.0 ** rng.uniform(-5.0, -3.0, (b, t, k))
    frames = np.arange(t, dtype=np.float32)
    decay_time = np.where(frames < 30, frames, frames - 30)
    decay_time = np.tile(decay_time[None, :, None], (b, 1, 1))
    return controls, _t(decays, device), _t(decay_time, device)


def _flat_decay_grads(grads):
    """DecayGrads as one tuple: the five controls', the decays', T's."""
    return tuple(grads.controls) + (grads.decays, grads.decay_time)


def _worst_share(got, want):
    """Each pair's largest difference over the plain one's peak."""
    return [((a - w).abs().max() / w.abs().max().clamp_min(1e-30)).item()
            for a, w in zip(got, want)]


@pytest.mark.cuda
def test_decay_oscillator_kernel_matches_plain(cuda_device):
    """K10 against ops.oscillator.render_framewise_decay: the phase,
    crossfade, frequency, mask and envelope round as the plain version's,
    the cosine and exp are within a few ulp of torch's, the accumulation
    rounds once a term and sums the partials in another order: 1e-5 of
    peak."""
    controls, decays, decay_time = _decay_inputs(cuda_device)
    build.reset_launches()
    got = tdec.render_framewise_decay_cuda(controls, decays, decay_time, 64,
                                           16000)
    torch.cuda.synchronize()
    assert build.LAUNCHES['oscillator_decay'] == 1
    want = tosc.render_framewise_decay(controls, decays, decay_time, 64,
                                       16000)
    err = _worst_share([got], [want])[0]
    print(f"\nK10 against its plain version: {err:.3g} of peak")
    assert err <= 1e-5


@pytest.mark.cuda
def test_decay_oscillator_bwd_kernel_matches_plain(cuda_device):
    """K11's seven gradients (controls, decays, T) against
    ops.oscillator.render_framewise_decay_vjp, each within 1e-5 of its
    peak; silent cells' d f, d phase0, d decays and d T are exact zeros
    on both sides."""
    controls, decays, decay_time = _decay_inputs(cuda_device)
    g = _t(np.random.RandomState(3).randn(4, 60 * 64), cuda_device)
    build.reset_launches()
    got = _flat_decay_grads(tdec.render_framewise_decay_bwd_cuda(
        controls, decays, decay_time, g, 64, 16000))
    torch.cuda.synchronize()
    assert build.LAUNCHES['oscillator_decay_bwd'] == 1
    want = _flat_decay_grads(tosc.render_framewise_decay_vjp(
        controls, decays, decay_time, g, 64, 16000))
    errs = _worst_share(got, want)
    print(f"\nK11 against its plain version, by gradient: "
          f"{[f'{e:.3g}' for e in errs]}")
    assert max(errs) <= 1e-5
    silent = (controls.a_lo[0, :19] == 0) & (controls.a_hi[0, :19] == 0)
    assert bool(silent.all())
    for i in (0, 1, 4, 5):
        assert torch.count_nonzero(got[i][0, :19]) == 0


@pytest.mark.cuda
def test_decay_function_on_cuda_matches_cpu(cuda_device):
    """The front door with gradients (RenderFramewiseDecay: K10 and K11 on
    the card) against the same Function on CPU tensors (its plain
    versions): the audio and the gradients of the partials' frequencies
    and amplitudes, the decays and T, each within 1e-4 of its peak (the
    CPU's and the card's sin, cos and exp differ in the last place)."""
    controls, decays, decay_time = _decay_inputs(torch.device('cpu'))
    g = torch.from_numpy(np.random.RandomState(3).randn(4, 60 * 64)
                         .astype(np.float32))
    results = []
    for device in (cuda_device, torch.device('cpu')):
        leaves = [x.to(device).requires_grad_()
                  for x in (*controls, decays, decay_time)]
        build.reset_launches()
        audio = tdec.render_framewise_decay_skip(
            tosc.FramewiseOscControls(*leaves[:5]), leaves[5], leaves[6], 64,
            16000)
        grads = torch.autograd.grad(audio, leaves, g.to(device))
        if device.type == 'cuda':
            torch.cuda.synchronize()
            assert build.LAUNCHES['oscillator_decay'] == 1
            assert build.LAUNCHES['oscillator_decay_bwd'] == 1
        results.append([x.detach().cpu() for x in (audio, *grads)])
    errs = _worst_share(*results)
    print(f"\nthe decay Function, cuda against cpu: "
          f"{[f'{e:.3g}' for e in errs]}")
    assert max(errs) <= 1e-4
