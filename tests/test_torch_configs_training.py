"""The training step of every config the port added after maestro_v2
(dafx22 and the five of tests/test_torch_configs.py) against jax.grad, and
the train CLI on an ENSTDkCl model, on the CPU.

Each case builds the config at reduced widths (4 voices, 16 harmonics, 16
noise bands; 0.5 s, or 2 s for enstdkcl_8khz, the length of its FDN's IR)
in its second phase, so that the detuners detune, and trains every
parameter that no phase freezes. The loss is the config's
list with the spectral loss's log-magnitude term off (its 1/|X| at
near-silent bins makes whole-step gradients ill-conditioned at init,
ROADMAP C.1), plus the regularisers. As in test_torch_training.py's whole
step, the JAX networks, reverb, noise synth and losses run jitted and the
tuning and additive synth op by op, with the noise draw injected.
"""

import os

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

from ddsp_piano_torch.params import flatten_tree, load_jax_params  # noqa

GRAD_CONFIGS = ('dafx22', 'enstdkcl_8khz', 'enstdkcl_32khz',
                'multi_instruments', 'surrogate', 'maestro_v2_regularized')
SMALL = dict(n_synths=4, n_harmonics=16, n_noise_bands=16)
# Seconds a segment. enstdkcl_8khz's standalone FDN has a 2 s IR (2 x 8000
# taps): against a 0.5 s segment, the gradient of the taps past the
# segment's end is 0 but for the FFT convolution's rounding (the 'same'
# crop of ops/filters.py fft_convolve), and the IR's t60 and tone leaves
# sum that rounding over 12000 taps (measured 0.64 of the t60 leaf's
# peak apart at 0.5 s, 1e-4 at 2 s).
SECONDS = {'enstdkcl_8khz': 2.0}
# Each leaf within GRAD_TOL of its peak: test_torch_training.py's tolerance
# for v2's magnitude term (K4's degree-4 trig against JAX's native trig,
# the float32 phase cumsum of tpu/ops/oscillator.py:169 against the port's
# float64; measured 6.9e-4 at most here, the surrogate's decay table). The
# leaves that reach the loss through the partial frequencies alone
# (inharmonicity, tuning and detuning) within FREQ_TOL: their gradient
# sums the phase's sensitivity 2 pi t over the segment, and the JAX
# package's own jitted and op-by-op gradients of them differ by up to
# 1.3e-2 (multi_instruments' detuner bias) and 3.6e-3 (dafx22's
# model_specific_weight); measured 3.8e-3 at most (enstdkcl_8khz, 2 s).
GRAD_TOL = 1e-3
FREQ_TOL = 5e-3
FREQ_LEAVES = ('inharm_model.slopes_modifier',
               'inharm_model.offsets_modifier',
               'inharm_model.model_specific_weight', 'detuner.',
               'z_encoder.detune_embedding.', 'z_encoder.inharm_embedding.')


def _batch(sample_rate, n_frames, n_synths=4, seed=0):
    """Two segments: held notes, onsets, a release, pedals, and a target
    drawn like get_dummy_data's; pianos 3 and 7 (the one-instrument
    configs clip every id to 0)."""
    rng = np.random.RandomState(seed)
    cond = np.zeros((2, n_frames, n_synths, 2), np.float32)
    for b in range(2):
        for voice, (pitch, start, end) in enumerate(
                [(43 + b, 5, 110), (59, 20, 60), (67 - b, 40, n_frames),
                 (72, 80, 100)][:n_synths]):
            cond[b, start:end, voice, 0] = pitch
            cond[b, start:start + 4, voice, 1] = 0.4 + 0.1 * voice
    pedal = np.zeros((2, n_frames, 4), np.float32)
    pedal[1, 30:, 0] = 0.7
    n_samples = n_frames * sample_rate // 250
    return {'conditioning': cond, 'pedal': pedal,
            'audio': rng.uniform(0.0, 1.0, (2, n_samples)).astype(np.float32),
            'piano_model': np.array([[3], [7]], np.int32)}


def _jax_step(config):
    """(losses, {leaf: gradient}, params) of jax.grad of the whole step."""
    from ddsp_piano_tpu.configs import get_model as jax_get_model

    seconds = SECONDS.get(config, 0.5)
    jmodel = jax_get_model(config, duration=seconds, first_phase=False,
                           **SMALL)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    jmodel.loss_objs[0].logmag_weight = 0.0
    for net in (jmodel.context_network, jmodel.monophonic_network,
                jmodel.reverb_model):
        if net is not None:
            net.apply = jax.jit(net.apply, static_argnames='training')
    group = jmodel.processor_group
    for proc in (group.noise, group.reverb):
        proc.get_signal = jax.jit(proc.get_signal)
    for loss in jmodel.loss_objs:
        if hasattr(loss, '_loss'):
            loss._loss = jax.jit(loss._loss)
    batch = _batch(jmodel.sample_rate, int(seconds * jmodel.frame_rate))
    feats = {k: jnp.asarray(v) for k, v in batch.items()}
    rng = jax.random.PRNGKey(7)
    # The noise synth's draw inside VectorizedPolyphonicProcessorGroup.
    noise = jax.random.uniform(jax.random.fold_in(rng, 1),
                               (8, batch['audio'].shape[1]), jnp.float32,
                               -1.0, 1.0)

    def total(p):
        losses = jmodel(p, feats, training=True, rng=rng)['losses']
        return losses['total_loss'], losses

    (_, losses), grads = jax.value_and_grad(total, has_aux=True)(params)
    return ({k: float(v) for k, v in losses.items()},
            dict(flatten_tree(jax.tree.map(np.asarray, grads))),
            params, batch, np.array(noise))


def _port_step(config, params, batch, noise):
    from ddsp_piano_torch.configs import get_model
    from ddsp_piano_torch.training.trainer import Trainer

    model = get_model(config, device='cpu', duration=SECONDS.get(config, 0.5),
                      first_phase=False, **SMALL)
    load_jax_params(model, jax.tree.map(np.asarray, params))
    model.loss_objs[0].logmag_weight = 0.0
    trainer = Trainer(model, first_phase=None)
    losses = trainer.forward_backward(
        {k: torch.from_numpy(v) for k, v in batch.items()},
        noise=torch.from_numpy(noise))
    # A parameter that the step does not reach (the z encoder's global
    # inharmonicity where the tuning takes none) has no .grad; jax.grad
    # gives it zeros.
    return ({k: float(v) for k, v in losses.items()},
            {n: (np.zeros(tuple(p.shape), np.float32) if p.grad is None
                 else p.grad.numpy().copy())
             for n, p in trainer.named_params})


@pytest.mark.parametrize('config', GRAD_CONFIGS)
def test_whole_step_gradients_match_jax(config):
    """Every trainable leaf's gradient within GRAD_TOL of its peak
    (FREQ_TOL for the frequency leaves), and every loss within rtol 1e-4
    (the render tolerance as a share of the loss)."""
    want_losses, want, params, batch, noise = _jax_step(config)
    got_losses, got = _port_step(config, params, batch, noise)
    assert sorted(got_losses) == sorted(want_losses)
    for key, value in want_losses.items():
        np.testing.assert_allclose(got_losses[key], value, rtol=1e-4,
                                   atol=1e-12, err_msg=key)
    assert np.isfinite(want_losses['total_loss'])
    errs = {}
    for name, g in got.items():
        peak = np.abs(want[name]).max()
        errs[name] = (np.abs(g - want[name]).max() / peak if peak > 0
                      else np.abs(g).max())
    worst = sorted(errs.items(), key=lambda kv: kv[1])[-3:]
    print(f"\n{config}: {len(errs)} leaves, worst {worst}, median "
          f"{np.median(list(errs.values())):.3g}")
    over = {name: err for name, err in errs.items()
            if err > (FREQ_TOL if name.startswith(FREQ_LEAVES)
                      else GRAD_TOL)}
    assert not over, over


def _write_mini_maestro(root, sample_rate, seconds=6.0):
    """A MAESTRO-layout folder of one train and one validation track."""
    from ddsp_piano_torch.data import audio_io, midi

    os.makedirs(root, exist_ok=True)
    rows = ['canonical_composer,canonical_title,split,year,midi_filename,'
            'audio_filename,duration']
    for i, split in enumerate(('train', 'validation')):
        notes = [midi.Note(48 + 7 * k + i, 80, 0.4 * k, 0.4 * k + 1.2)
                 for k in range(int(seconds / 0.4) - 3)]
        name = f'track{i}'
        midi.write_midi(os.path.join(root, name + '.midi'), notes,
                        [midi.ControlChange(0.0, 64, 0)])
        t = np.arange(int(seconds * sample_rate)) / sample_rate
        audio_io.write_wav(os.path.join(root, name + '.wav'),
                           0.3 * np.sin(2 * np.pi * 220.0 * (1 + i) * t),
                           sample_rate)
        rows.append(f'c,t,{split},2018,{name}.midi,{name}.wav,{seconds}')
    with open(os.path.join(root, 'maestro-v3.0.0.csv'), 'w') as f:
        f.write('\n'.join(rows) + '\n')
    return root


def test_train_cli_phases_1_and_2_enstdkcl(tmp_path, monkeypatch):
    """train_single_phase -c enstdkcl_8khz, phase 1 then phase 2 restored
    from it: the standalone FDN's parameters train in both phases, the
    networks only in the first and ParametricTuning's modifiers only in
    the second."""
    from ddsp_piano_torch import configs
    from ddsp_piano_torch import train_single_phase as cli
    from ddsp_piano_torch.data import pipeline

    real_get_model = configs.get_model
    monkeypatch.setattr(configs, 'get_model', lambda *a, **kw: real_get_model(
        *a, n_synths=4, n_harmonics=16, **kw))
    real_dataset = pipeline.get_training_dataset
    monkeypatch.setattr(pipeline, 'get_training_dataset',
                        lambda *a, **kw: real_dataset(
                            *a, shuffle_buffer_segments=4, **kw))
    root = _write_mini_maestro(str(tmp_path / 'maestro'), 8000)
    exp = str(tmp_path / 'exp')
    common = ['-c', 'enstdkcl_8khz', '-b', '1', '-s', '2', '-e', '1',
              '--device', 'cpu', '--seed', '3']
    initial = {n: p.detach().clone() for n, p in real_get_model(
        'enstdkcl_8khz', device='cpu', seed=3, n_synths=4,
        n_harmonics=16).named_parameters()}
    first = cli.main(cli.process_args(common + [root, exp]))
    phase1 = os.path.join(exp, 'phase_1', 'last_iter')
    after1 = {n: p.detach().clone()
              for n, p in first['trainer'].model.named_parameters()}
    second = cli.main(cli.process_args(common + ['-p', '2', '-r', phase1,
                                                 root, exp]))
    after2 = dict(second['trainer'].model.named_parameters())
    assert np.isfinite(first['step_losses']).all()
    assert np.isfinite(second['step_losses']).all()

    def moved(a, b, name):
        return not torch.equal(a[name], b[name].detach())

    fdn = [n for n in after1 if n.startswith('processor_group.DelayNetwork.')]
    assert 'processor_group.DelayNetwork.delay_values' in fdn
    for name in fdn:
        assert moved(initial, after1, name), name
        assert moved(after1, after2, name), name
    for name in ('monophonic_network.dense_out.kernel',
                 'context_network.dense_out.kernel'):
        assert moved(initial, after1, name)
        assert not moved(after1, after2, name)
    for name in ('inharm_model.slopes_modifier',
                 'inharm_model.offsets_modifier'):
        assert not moved(initial, after1, name)
        assert moved(after1, after2, name)
    for name in ('inharm_model.slopes', 'inharm_model.offsets'):
        assert not moved(initial, after2, name)
