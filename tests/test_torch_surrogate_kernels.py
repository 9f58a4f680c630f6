"""The surrogate synth's decaying partials on the CPU: the plain versions
of K10 and K11 (ops.oscillator.render_framewise_decay and its written-out
VJP) against the JAX package's render and jax.vjp of it, the front door's
autograd Function against autograd of the plain render, the benchmark's
plain reference of the surrogate model against the port, and the build
group that keeps K10 and K11 apart from the other kernels. The kernels
themselves run only on the card (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import threadpoolctl

torch = pytest.importorskip('torch')
torch.set_num_threads(1)
# numpy's BLAS too, for the whole worker (xdist collects every file).
threadpoolctl.threadpool_limits(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ddsp_piano_torch.kernels import oscillator_decay as tdec  # noqa: E402
from ddsp_piano_torch.ops import core as tcore  # noqa: E402
from ddsp_piano_torch.ops import oscillator as tosc  # noqa: E402
from ddsp_piano_torch.processors import surrogate as tsur  # noqa: E402
from ddsp_piano_tpu.processors import surrogate as jsur  # noqa: E402

UP, SR = 64, 16000


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _peak_err(got, want):
    got, want = (np.asarray(x.detach() if isinstance(x, torch.Tensor)
                            else x) for x in (got, want))
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _inputs(b=3, t=30, k=12, seed=7):
    """Frame-rate controls of surrogate_harmonic_synthesis: a pitch jump,
    a voice silent for its first frames, decays 1 - 10^u (u in [-5, -3])
    and the frames since onsets at 0 and 12."""
    rng = np.random.RandomState(seed)
    f0 = np.repeat(110.0 * 2 ** rng.rand(b, 1, 1), t, 1).astype(np.float32)
    f0[0, 15:] *= 1.5
    amps = rng.rand(b, t, 1).astype(np.float32)
    amps[1, :6] = 0.0
    dist = rng.rand(b, t, k).astype(np.float32)
    shifts = (1e-4 * rng.rand(b, t, k)).astype(np.float32)
    decays = (1.0 - 10.0 ** rng.uniform(-5.0, -3.0, (b, t, k))).astype(
        np.float32)
    frames = np.arange(t, dtype=np.float32)
    decay_time = np.tile(np.where(frames < 12, frames, frames - 12)[
        None, :, None], (b, 1, 1)).astype(np.float32)
    return f0, amps, decays, decay_time, shifts, dist


def test_decay_render_and_gradients_match_jax():
    """The port's surrogate_harmonic_synthesis through the front door's
    Function (the plain render, the written-out VJP on the CPU) against
    the JAX package's jnp render and jax.vjp of it: the audio within 1e-4
    of peak (the JAX package's float32 phase cumsum against the port's
    float64, tests/test_torch_configs.py), and the gradients of the
    amplitudes, the harmonic distribution, the decays and decay_time
    within 1e-3 of their peaks, as the configs' training steps hold
    theirs (tests/test_torch_configs_training.py GRAD_TOL)."""
    f0, amps, decays, decay_time, shifts, dist = _inputs()
    args = dict(upsampling=UP, sample_rate=SR)
    g = np.random.RandomState(3).randn(3, 30 * UP).astype(np.float32)

    def jax_render(amps, decays, decay_time, dist):
        return jsur.surrogate_harmonic_synthesis(
            jnp.asarray(f0), amps, decays, decay_time, jnp.asarray(shifts),
            dist, **args)

    want, vjp = jax.vjp(jax_render, *(jnp.asarray(x) for x in
                                      (amps, decays, decay_time, dist)))
    want_grads = vjp(jnp.asarray(g))
    leaves = [_t(x).requires_grad_() for x in (amps, decays, decay_time,
                                               dist)]
    got = tsur.surrogate_harmonic_synthesis(
        _t(f0), leaves[0], leaves[1], leaves[2], _t(shifts), leaves[3],
        **args)
    got_grads = torch.autograd.grad(got, leaves, _t(g))
    assert _peak_err(got, want) <= 1e-4
    for name, a, w in zip(('amplitudes', 'decays', 'decay_time',
                           'harmonic_distribution'), got_grads, want_grads):
        assert _peak_err(a, w) <= 1e-3, name


@pytest.mark.parametrize('inputs', ['grad', 'no_grad'])
def test_front_door_equals_the_plain_render(inputs):
    """On CPU tensors the front door is the plain render, with and without
    inputs that require grad, and the Function's gradients (the
    written-out VJP) agree with autograd of the plain render within 1e-6
    of each peak, for the five controls, the decays and decay_time."""
    f0, amps, decays, decay_time, shifts, dist = _inputs()
    freqs = tcore.get_harmonic_frequencies(_t(f0), 12) * (1.0 + _t(shifts))
    base = tosc.framewise_osc_controls(freqs, _t(amps) * _t(dist), UP, SR)
    leaves = [x.detach().clone().requires_grad_(inputs == 'grad')
              for x in (*base, _t(decays), _t(decay_time))]
    controls = tosc.FramewiseOscControls(*leaves[:5])
    got = tdec.render_framewise_decay_skip(controls, leaves[5], leaves[6],
                                           UP, SR)
    want = tosc.render_framewise_decay(controls, leaves[5], leaves[6], UP,
                                       SR)
    assert torch.equal(got, want)
    if inputs == 'no_grad':
        return
    g = torch.randn(got.shape, generator=torch.Generator().manual_seed(4))
    got_grads = torch.autograd.grad(got, leaves, g)
    want_grads = torch.autograd.grad(want, leaves, g)
    for i, (a, w) in enumerate(zip(got_grads, want_grads)):
        assert _peak_err(a, w) <= 1e-6, i


def test_decay_vjp_of_silent_and_inaudible_cells_is_zero():
    """Where a frame's partial is silent (both amplitudes 0) the plain VJP
    gives exact zeros to its frequencies, phase, decay and T share, and
    where it lies at or above Nyquist over the frame, zeros to all seven:
    the cells K11 skips or stores as 0."""
    f0, amps, decays, decay_time, shifts, dist = _inputs()
    f0[2] = 2000.0                       # partials 4-12 past 8 kHz
    freqs = tcore.get_harmonic_frequencies(_t(f0), 12) * (1.0 + _t(shifts))
    controls = tosc.framewise_osc_controls(freqs, _t(amps) * _t(dist), UP,
                                           SR)
    g = torch.randn((3, 30 * UP), generator=torch.Generator().manual_seed(5))
    grads = tosc.render_framewise_decay_vjp(controls, _t(decays),
                                            _t(decay_time), g, UP, SR)
    silent = grads.controls
    for x in (silent.f_lo, silent.f_hi, silent.phase0, grads.decays):
        assert torch.count_nonzero(x[1, :5]) == 0
    assert torch.count_nonzero(grads.decay_time[1, :5]) == 0
    above = torch.minimum(controls.f_lo, controls.f_hi)[2] >= SR / 2
    assert bool(above[:, 4:].all())
    for x in (*grads.controls, grads.decays):
        assert torch.count_nonzero(x[2][above]) == 0


def test_build_groups_keep_the_decay_kernels_apart(tmp_path, monkeypatch):
    """library() builds only the group of the source it loads: a model
    without the surrogate synth never compiles K10 and K11, and the
    surrogate's first call compiles them alone. The compiler is a stub
    that writes its output and logs its source."""
    from ddsp_piano_torch.kernels import build

    log = tmp_path / 'compiled.log'
    nvcc = tmp_path / 'nvcc'
    nvcc.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n'
                    f'echo "$3" >> {log}\necho built > "$2"\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(build, 'BUILD_ROOT', tmp_path / 'kernels')
    monkeypatch.setattr(build, 'nvcc_path', lambda: str(nvcc))
    assert sorted(build.GROUPS['surrogate']) == ['oscillator_decay',
                                                 'oscillator_decay_bwd']
    assert sorted(sum(build.GROUPS.values(), ())) == sorted(build.SIGNATURES)
    built = build.build_all(build.GROUPS['common'])
    assert sorted(built) == sorted(build.GROUPS['common'])
    assert not any('oscillator_decay' in line
                   for line in log.read_text().split())
    built = build.build_all(build.GROUPS['surrogate'])
    assert sorted(built) == ['oscillator_decay', 'oscillator_decay_bwd']
    assert build.build_all() == {}


def _reference_and_port(seed=12345, seconds=0.4):
    """The benchmark's plain reference of the surrogate model at its
    published widths, its weights from ``seed`` (the decay table drawn
    too), and the port's model holding the same weights."""
    from portbench import program
    from portbench.reference import piano as reference

    config = {'registry_name': 'surrogate',
              'build': dict(sample_rate=16000, frame_rate=250,
                            n_instruments=1, n_synths=16, z_dim=16,
                            n_harmonics=96, n_noise_bands=64)}
    ref = reference.build(config, False, seconds, seed, 'cpu')
    port = program.model(config, ref.state_dict(), inference=False,
                         duration=seconds, device='cpu')
    return ref, port


def _features(n_frames=100, b=2, seed=0):
    rng = np.random.RandomState(seed)
    cond = np.zeros((b, n_frames, 16, 2), np.float32)
    for row in range(b):
        for voice, (pitch, start, end) in enumerate(
                [(43 + row, 5, 90), (59, 20, 60), (67 - row, 40, n_frames),
                 (72, 70, 95)]):
            cond[row, start:end, voice, 0] = pitch
            cond[row, start:start + 8, voice, 1] = 0.4 + 0.1 * voice
    pedal = np.zeros((b, n_frames, 4), np.float32)
    pedal[:, 30:70, 0] = 127 / 128
    n_samples = n_frames * UP
    return ({'conditioning': torch.from_numpy(cond),
             'pedal': torch.from_numpy(pedal),
             'piano_model': torch.zeros((b, 1), dtype=torch.int32),
             'audio': torch.from_numpy((0.1 * rng.randn(b, n_samples))
                                       .astype(np.float32))},
            torch.from_numpy((2.0 * rng.rand(16 * b, n_samples) - 1.0)
                             .astype(np.float32)))


def test_reference_surrogate_matches_the_port():
    """portbench's plain reference of the surrogate model (autograd of its
    plain render) against the port (the written-out VJP) on seeded
    weights, a seeded decay table included, in phase 1: the render, each
    loss, and one step's gradients, each leaf within 1e-3 of its peak
    (the configs' tolerance, tests/test_torch_configs_training.py)."""
    ref, port = _reference_and_port()
    assert not torch.all(ref.surrogate_module.amp_model.embeddings == 1.0)
    features, noise = _features()
    outs, grads = [], []
    for model in (ref, port):
        model.set_trainable(True)
        out = model(features, noise=noise, training=True)
        params = [p for p in model.parameters() if p.requires_grad]
        grads.append(torch.autograd.grad(out['losses']['total_loss'],
                                         params, allow_unused=True))
        outs.append(out)
    assert _peak_err(outs[1]['audio_synth'], outs[0]['audio_synth']) <= 1e-6
    for key, value in outs[0]['losses'].items():
        assert float(outs[1]['losses'][key].detach()) == pytest.approx(
            float(value.detach()), rel=1e-6, abs=1e-9), key
    names = [n for n, p in ref.named_parameters() if p.requires_grad]
    assert names == [n for n, p in port.named_parameters()
                     if p.requires_grad]
    for name, want, got in zip(names, *grads):
        if want is None:
            assert got is None, name
            continue
        assert _peak_err(got, want) <= 1e-3, name


def test_reference_trainable_mask_matches_the_trainer():
    """The reference's phase rule, the surrogate module in phase 2 only,
    against the port's Trainer in phases 1 and 2 (and every leaf in
    neither)."""
    from ddsp_piano_torch.training.trainer import Trainer

    ref, port = _reference_and_port(seconds=0.2)
    for first_phase in (True, False, None):
        trainer = Trainer(port, first_phase=first_phase)
        want = ref.trainable_mask(first_phase)
        assert trainer.mask == want
        assert want['surrogate_module.amp_model.embeddings'] == (
            first_phase is not True)
        assert [n for n, _ in trainer.named_params] == [
            n for n, trainable in want.items() if trainable]
