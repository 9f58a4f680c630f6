"""The port's gradient kernels (K4-K7) against the JAX package's.

On the CPU the port's front doors run each kernel's plain PyTorch version;
the JAX kernels run in Pallas interpret mode, as the JAX package's own
tests run them. The same numpy inputs go through both. With grad enabled
the front doors go through the port's torch.autograd.Functions, held here
against jax.vjp of the JAX package's reference functions. The CUDA kernels
against their plain versions on the card: tests/test_torch_cuda.py. At the
end, the v2 loss's 10-step trajectories through those gradients against
the JAX trainer's (ROADMAP C.1; tests/test_torch_staging.py holds the
magnitude term's).
"""

import numpy as np
import pytest
import threadpoolctl

torch = pytest.importorskip('torch')
torch.set_num_threads(1)
# numpy's BLAS too, for the whole worker (xdist collects every file):
# threaded OpenBLAS stalls at each call's barrier on a loaded host.
threadpoolctl.threadpool_limits(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ddsp_piano_torch.kernels import build  # noqa: E402
from ddsp_piano_torch.kernels import gru as tgru  # noqa: E402
from ddsp_piano_torch.kernels import note_release as tnr  # noqa: E402
from ddsp_piano_torch.kernels import oscillator as tosck  # noqa: E402
from ddsp_piano_torch.ops import core as tcore  # noqa: E402
from ddsp_piano_torch.ops import oscillator as tosc  # noqa: E402
from ddsp_piano_tpu.kernels import gru_pallas as gp  # noqa: E402
from test_torch_training import (check_loss_curve_distributions,  # noqa
                                 check_ten_step_trajectory, jax_v2)
from ddsp_piano_tpu.kernels.oscillator_pallas import (  # noqa: E402
    render_framewise_pallas_skip_vjp)
from ddsp_piano_tpu.ops import oscillator as josc  # noqa: E402


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _grad_inputs(*arrays):
    return [_t(a).requires_grad_() for a in arrays]


# -- K4: oscillator backward --------------------------------------------------


def _osc_case(sr, up, K, b, n_frames, seed, silent_f0=0.0):
    """test_oscillator.py:247-256: a silent stretch (f0 ``silent_f0``),
    Nyquist-masked partials, a random audio cotangent."""
    rng = np.random.RandomState(seed)
    f0 = rng.uniform(20, sr * 3 / 8, (b, n_frames, 1)).astype(np.float32)
    f0[0, :n_frames // 5] = silent_f0
    freqs = (f0 * np.arange(1, K + 1, dtype=np.float32)).astype(np.float32)
    amps = rng.rand(b, n_frames, K).astype(np.float32)
    amps[0, :n_frames // 5] = 0.0
    controls = josc.framewise_osc_controls(jnp.asarray(freqs),
                                           jnp.asarray(amps), up, sr)
    g = rng.randn(b, n_frames * up).astype(np.float32)
    return controls, g


OSC_CASES = [(16000, 64, 40, 2, 140),     # test_oscillator.py:247-256
             (24000, 96, 128, 2, 30)]     # the v2 widths


@pytest.mark.parametrize('sr,up,K,b,n_frames', OSC_CASES)
def test_oscillator_vjp_plain_matches_pallas(sr, up, K, b, n_frames):
    controls, g = _osc_case(sr, up, K, b, n_frames, seed=5)
    want = render_framewise_pallas_skip_vjp(controls, jnp.asarray(g), up,
                                            sr, True, 'poly4')
    port = tosc.FramewiseOscControls(*(_t(c) for c in controls))
    got = tosck.render_framewise_vjp_plain(port, _t(g), up, sr)
    for name, w, gt in zip(port._fields, want, got):
        w = np.asarray(w)
        # 2e-4 x each gradient's peak (test_oscillator.py:268). The terms
        # are the same operations, but the interpreted kernel runs under
        # jit, where XLA contracts multiply-adds, so its phases differ by
        # an ulp (3e-5 rad at the 300 rad of a v2 frame). Against the
        # float64 gradient both sides are off by up to 1.6e-4 of peak at
        # the v2 widths; they differ by up to 1.46e-4 (measured).
        np.testing.assert_allclose(gt.numpy(), w,
                                   atol=2e-4 * np.abs(w).max(),
                                   err_msg=name)


@pytest.mark.parametrize('sr,up,K,b,n_frames', OSC_CASES)
def test_silent_cells_carry_only_amplitude_gradients(sr, up, K, b,
                                                     n_frames):
    """What K4's silent path relies on: a cell below Nyquist with a_lo ==
    a_hi == 0 (here a voice held at midi_to_hz(0), as the model holds one
    with no note) has d f_lo, d f_hi and d phase0 exactly 0 and non-zero
    amplitude gradients, in the plain VJP and in the JAX kernel."""
    controls, g = _osc_case(sr, up, K, b, n_frames, seed=11,
                            silent_f0=float(tcore.midi_to_hz(0.0)))
    want = render_framewise_pallas_skip_vjp(controls, jnp.asarray(g), up,
                                            sr, True, 'poly4')
    port = tosc.FramewiseOscControls(*(_t(c) for c in controls))
    got = tosck.render_framewise_vjp_plain(port, _t(g), up, sr)
    silent = ((torch.minimum(port.f_lo, port.f_hi) < sr / 2.0)
              & (port.a_lo == 0.0) & (port.a_hi == 0.0))
    assert int(silent.sum()) >= K * (n_frames // 5 - 1)
    for grads in (got, [_t(w) for w in want]):
        for d in (grads[0], grads[1], grads[4]):      # f_lo, f_hi, phase0
            assert torch.all(d[silent] == 0.0)
        for d in (grads[2], grads[3]):                # a_lo, a_hi
            assert torch.all(d[silent] != 0.0)


def test_oscillator_backward_bound_skips_only_silent_gradients():
    """Partials past the backward's Nyquist-only bound have exactly zero
    gradient in the plain VJP; silent partials below it do not."""
    controls, g = _osc_case(16000, 64, 40, 2, 140, seed=1)
    port = tosc.FramewiseOscControls(*(_t(c) for c in controls))
    k_last = tosck.audible_partials(port, 16000)
    past = torch.arange(1, 41)[None, None, :] > k_last[..., None]
    grads = tosck.render_framewise_vjp_plain(port, _t(g), 64, 16000)
    assert past.any()
    for grad in grads:
        assert torch.all(grad[past] == 0.0)
    # The silent stretch keeps amplitude gradients.
    assert torch.any(grads.a_lo[0, :28] != 0.0)
    assert torch.all(tosck.active_partials(port, 16000)[0, :27] == 0)


def test_oscillator_function_matches_jax_vjp():
    sr, up, K, b, n_frames = 16000, 64, 40, 2, 140
    controls, g = _osc_case(sr, up, K, b, n_frames, seed=7)

    def jnp_render(*c):
        return josc.render_framewise(josc.FramewiseOscControls(*c), up, sr,
                                     backend='jnp')

    _, vjp = jax.vjp(jnp_render, *controls)
    want = vjp(jnp.asarray(g))
    inputs = _grad_inputs(*controls)
    build.reset_launches()
    audio = tosck.render_framewise_skip(tosc.FramewiseOscControls(*inputs),
                                        up, sr)
    assert audio.grad_fn is not None
    got = torch.autograd.grad(audio, inputs, _t(g))
    assert all(v == 0 for v in build.LAUNCHES.values())
    for name, w, gt in zip(josc.FramewiseOscControls._fields, want, got):
        w = np.asarray(w)
        # 2e-4 x peak, test_oscillator.py:268: the port's degree-6 forward
        # and degree-4 backward trig against JAX's native transcendentals.
        np.testing.assert_allclose(gt.numpy(), w,
                                   atol=2e-4 * np.abs(w).max(),
                                   err_msg=name)


# -- K5: GRU backward ---------------------------------------------------------


def _gru_case(T, B, u, seed):
    rng = np.random.RandomState(seed)
    x_proj = (0.3 * rng.randn(T, B, 3 * u)).astype(np.float32)
    rec = (0.5 * np.linalg.qr(rng.randn(3 * u, u))[0].T).astype(np.float32)
    bias = (0.1 * rng.randn(3 * u)).astype(np.float32)
    h0 = (0.5 * rng.randn(B, u)).astype(np.float32)
    g = rng.randn(T, B, u).astype(np.float32)
    return x_proj, rec, bias, h0, g


@pytest.mark.parametrize('u', [64, 192])
def test_gru_bwd_plain_matches_pallas(u):
    # T = 70 is not a multiple of the TPU kernel's 64-step time block.
    x_proj, rec, bias, h0, g = _gru_case(70, 3, u, seed=u)
    jargs = [jnp.asarray(a) for a in (x_proj, rec, bias, h0)]
    hs = gp.gru_scan_reference(*jargs)
    want = gp.gru_scan_pallas_bwd(*jargs, hs, jnp.asarray(g), True)
    streams = tgru.gru_scan_plain_bwd(_t(x_proj), _t(rec), _t(bias),
                                      _t(h0), _t(np.asarray(hs)), _t(g))
    got = tgru.gru_grads_from_streams(_t(h0), _t(np.asarray(hs)), streams)
    for name, a, w in zip(('dx_proj', 'd_rec_kernel', 'd_rec_bias', 'dh0'),
                          got, want):
        # rtol 1e-4, atol 1e-5: test_ctrl_kernels.py:106-108.
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


def test_gru_function_matches_jax_vjp():
    x_proj, rec, bias, h0, g = _gru_case(37, 4, 16, seed=11)
    jargs = [jnp.asarray(a) for a in (x_proj, rec, bias, h0)]
    _, pull = jax.vjp(gp.gru_scan_reference, *jargs)
    want = pull(jnp.asarray(g))
    inputs = _grad_inputs(x_proj, rec, bias, h0)
    hs = tgru.gru_scan(*inputs)
    assert type(hs.grad_fn).__name__ == 'GRUScanBackward'
    got = torch.autograd.grad(hs, inputs, _t(g))
    for name, a, w in zip(('dx_proj', 'd_rec_kernel', 'd_rec_bias', 'dh0'),
                          got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    # Without grad the front door takes the plain forward.
    with torch.no_grad():
        np.testing.assert_array_equal(
            tgru.gru_scan(*inputs).numpy(),
            tgru.gru_scan_plain(*(a.detach() for a in inputs)).numpy())


# -- K6 / K7: NoteRelease residual forward and backward ------------------------

# release_duration 1.1 s at 250 frames/s: 275.0 exactly in float32.
THRESHOLD = float(np.float32(1.1) * np.float32(250.0))


def _note_release_case(seed, dyadic):
    """T = 700 (not a multiple of the TPU kernels' 128-frame block); lane 0
    releases for 300 frames, so steps - threshold passes 0 and 1 exactly;
    lane 1 holds the pitch 1.0 (the activity's min tie); lane 2 has short
    gaps; lane 3 starts mid-release near the threshold.

    ``dyadic``: cotangents in quarters of [-1, 1] and no fractional pitch,
    so every product and sum of the backward walk is exact and any order
    of operations, contracted multiply-adds included, gives the same bits.
    Otherwise normal cotangents and a stretch of pitch 0.5 (the interior
    of the activity's relu)."""
    assert THRESHOLD == 275.0
    rng = np.random.RandomState(seed)
    T, B = 700, 4
    x = np.zeros((T, B, 1), np.float32)
    x[10:60, 0, 0] = 60.0
    x[400:430, 0, 0] = 48.0
    x[5:40, 1, 0] = 1.0
    if not dyadic:
        x[340:360, 1, 0] = 0.5
    for s in range(0, T - 40, 90):
        x[s:s + 30, 2, 0] = rng.randint(30, 90)
    x[300:320, 3, 0] = 72.0
    s0 = np.zeros((B, 2), np.float32)
    s0[3] = [50.0, 270.0]
    if dyadic:
        g_out = (rng.randint(-4, 5, (T, B, 1)) / 4.0).astype(np.float32)
        g_state = (rng.randint(-4, 5, (B, 2)) / 4.0).astype(np.float32)
    else:
        g_out = rng.randn(T, B, 1).astype(np.float32)
        g_state = rng.randn(B, 2).astype(np.float32)
    return x, np.asarray([THRESHOLD], np.float32), s0, g_out, g_state


@pytest.mark.parametrize('dyadic', [True, False],
                         ids=['exact_arithmetic', 'normal_cotangents'])
def test_note_release_res_and_bwd_plain_match_pallas(dyadic):
    x, thr, s0, g_out, g_state = _note_release_case(3, dyadic)
    jx, jthr, js0 = (jnp.asarray(a) for a in (x, thr, s0))
    out, final, steps = gp.note_release_scan_pallas_res.__wrapped__(
        jx, jthr, js0, interpret=True)
    got_out, got_final, got_steps = tnr.note_release_scan_plain_res(
        _t(x), _t(thr), _t(s0))
    # Bit-exact (gru_pallas.py:706-708): min, max and products of pitches
    # and whole frame counts.
    np.testing.assert_array_equal(got_out.numpy(), np.asarray(out))
    np.testing.assert_array_equal(got_final.numpy(), np.asarray(final))
    np.testing.assert_array_equal(got_steps.numpy(), np.asarray(steps))
    # The release count hits the threshold exactly: both ties occur.
    u = got_steps.numpy() - thr[0]
    assert (u == 0.0).any() and (u == 1.0).any()

    prev = jnp.concatenate([js0[:, 0][jnp.newaxis], out[:-1, :, 0]], axis=0)
    want = gp._note_release_bwd_streams(
        jx, jthr, prev, steps, jnp.asarray(g_out), jnp.asarray(g_state),
        interpret=True)
    want = [np.asarray(w) for w in want]
    want = [want[0], want[1][0], want[2].T]
    got = tnr.note_release_scan_plain_bwd(
        _t(x), _t(thr), _t(np.asarray(prev)), got_steps, _t(g_out),
        _t(g_state))
    for name, a, w in zip(('dx', 'dthreshold per lane', 'dstate0'), got,
                          want):
        if dyadic:
            # Bit-exact (gru_pallas.py:706-708).
            np.testing.assert_array_equal(a.numpy(), w, err_msg=name)
        else:
            # The interpreted kernel runs under jit, where XLA contracts
            # multiply-adds; the port rounds each operation on its own, as
            # the CUDA kernel does: a few ulps (measured 1.5e-7 relative).
            np.testing.assert_allclose(a.numpy(), w, rtol=1e-6,
                                       atol=1e-6 * np.abs(w).max(),
                                       err_msg=name)
    _, want_dthr, _ = gp.note_release_scan_pallas_bwd(
        jx, jthr, prev, steps, jnp.asarray(g_out), jnp.asarray(g_state),
        True)
    # The cross-lane sum of four floats, in two libraries' orders.
    np.testing.assert_allclose(float(got[1].sum()),
                               float(np.asarray(want_dthr)[0]), rtol=1e-6)


def test_note_release_gradient_ties_match_jax_exactly():
    """The repair: d threshold, d active_pitch and d state0 at the 0 and 1
    ties equal jax.vjp of note_release_reference bit for bit, where torch's
    autograd of the clamp-based forward does not."""
    x, thr, s0, g_out, g_state = _note_release_case(4, dyadic=True)
    _, pull = jax.vjp(gp.note_release_reference, jnp.asarray(x),
                      jnp.asarray(thr), jnp.asarray(s0))
    want = [np.asarray(w) for w in pull((jnp.asarray(g_out),
                                         jnp.asarray(g_state)))]
    assert want[1][0] != 0.0          # the threshold's gradient is live

    inputs = _grad_inputs(x, thr, s0)
    ys, state = tnr.note_release_scan(*inputs)
    got = torch.autograd.grad([ys, state], inputs, [_t(g_out), _t(g_state)])
    for name, a, w in zip(('d active_pitch', 'd threshold', 'd state0'),
                          got, want):
        np.testing.assert_array_equal(a.numpy(), w, err_msg=name)

    inputs = _grad_inputs(x, thr, s0)
    ys, state = tnr.note_release_scan_plain(*inputs)
    clamp = torch.autograd.grad([ys, state], inputs,
                                [_t(g_out), _t(g_state)])
    assert not all(np.array_equal(a.numpy(), w) for a, w in zip(clamp, want))


def test_note_release_module_release_duration_gradient():
    """The NoteRelease module's release_duration gradient through the front
    door equals JAX's (test_ctrl_kernels.py:334-364); the releases here
    outlast the threshold, so it is not zero."""
    from ddsp_piano_torch.models import sub_modules as tsm
    from ddsp_piano_tpu.models import sub_modules as jsm

    cond = np.zeros((3, 700, 2), np.float32)
    cond[:, 20:70, 0] = 60.0
    cond[:, 500:530, 0] = 72.0
    weights = np.random.RandomState(0).randn(3, 700, 1).astype(np.float32)
    jnr = jsm.NoteRelease(frame_rate=250)
    params = jnr.init(jax.random.PRNGKey(0))

    def loss(p):
        return jnp.sum(jnr.apply(p, jnp.asarray(cond)) * weights)

    want = float(np.asarray(
        jax.grad(loss)(params)['cell']['release_duration']))
    nr = tsm.NoteRelease(frame_rate=250)
    torch.sum(nr(_t(cond)) * _t(weights)).backward()
    got = float(nr.cell.release_duration.grad)
    assert want != 0.0
    # rtol 1e-5: test_ctrl_kernels.py:362-364.
    np.testing.assert_allclose(got, want, rtol=1e-5)


# -- ROADMAP C.1 for the v2 loss ------------------------------------
# The checks are test_torch_training.py's; one loss a file, so that
# pytest-xdist's --dist loadfile runs the two losses' trajectories on two
# workers.


@pytest.mark.parametrize('loss', ['v2'])
def test_ten_step_trajectory_matches_jax_trainer(jax_v2, loss):
    check_ten_step_trajectory(jax_v2, loss)


@pytest.mark.parametrize('loss', ['v2'])
def test_loss_curve_distributions_match_jax_trainer(jax_v2, loss):
    check_loss_curve_distributions(jax_v2, loss)
