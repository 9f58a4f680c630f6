"""The train CLI's -k, --staging, --profile and --debug_nans, the
three-phase recipe and the config smoke CLI, on the CPU.

Each run trains maestro_v2 at 4 voices and 16 harmonics on 1 s segments of
a preprocessed mini-MAESTRO cache (one 2 s track; test_torch_training.py's
_write_mini_maestro, cached by the port's preprocess CLI). Each flag's
losses and final parameters are held bit-equal to those of the default
path (K = 1, --staging packed): -k 4 against 4 single steps, the three
stagings against one another, the profiled run against the default run
with the profiled steps added (its trace holding the program's spans),
--debug_nans against the run without it.
"""

import json
import os

import numpy as np
import pytest
import threadpoolctl

torch = pytest.importorskip('torch')
torch.set_num_threads(1)
# numpy's BLAS too, for the whole worker (xdist collects every file):
# threaded OpenBLAS stalls at each call's barrier on a loaded host.
threadpoolctl.threadpool_limits(1)

from test_torch_training import _write_mini_maestro  # noqa: E402

from ddsp_piano_torch import tracing  # noqa: E402

SEGMENT_SECONDS = 1.0
SMALL = dict(n_synths=4, n_harmonics=16)
_DEFAULT_RUNS = {}


@pytest.fixture(scope='module')
def cache(tmp_path_factory):
    """python -m ddsp_piano_torch.preprocess_maestro of a one-track
    mini-MAESTRO (2 s at 24 kHz)."""
    from ddsp_piano_torch import preprocess_maestro

    root = tmp_path_factory.mktemp('data')
    maestro = _write_mini_maestro(str(root / 'maestro'), sample_rate=24000,
                                  seconds=2.0)
    out = str(root / 'cache')
    preprocess_maestro.main(preprocess_maestro.process_args(
        ['--num_workers', '1', '-p', '4', maestro, out]))
    return out


@pytest.fixture
def small(monkeypatch):
    """The CLIs' model at 4 voices and 16 harmonics, on 1 s segments with a
    4-segment shuffle buffer."""
    from ddsp_piano_torch import configs
    from ddsp_piano_torch.data import pipeline

    real_get_model = configs.get_model
    monkeypatch.setattr(configs, 'get_model', lambda *a, **kw: real_get_model(
        *a, **{**SMALL, 'duration': SEGMENT_SECONDS, **kw}))
    for name in ('get_training_dataset', 'get_validation_dataset'):
        real = getattr(pipeline, name)
        monkeypatch.setattr(pipeline, name, lambda *a, _real=real, **kw: _real(
            *a, duration=SEGMENT_SECONDS, shuffle_buffer_segments=4, **kw))
    return real_get_model


def _train(cache, exp, argv):
    from ddsp_piano_torch import train_single_phase as cli

    return cli.main(cli.process_args(
        ['-b', '1', '-e', '1', '--device', 'cpu', '--seed', '3'] + argv
        + [cache, exp]))


def _default_run(cache, tmp_path_factory, steps):
    """The default path (K = 1, --staging packed) for ``steps`` steps,
    once per module."""
    if steps not in _DEFAULT_RUNS:
        exp = str(tmp_path_factory.mktemp(f'default_{steps}'))
        result = _train(cache, exp, ['-s', str(steps)])
        _DEFAULT_RUNS[steps] = (
            result['step_losses'],
            {n: p.detach().clone()
             for n, p in result['trainer'].model.named_parameters()})
    return _DEFAULT_RUNS[steps]


@pytest.mark.parametrize('flags,steps,extra', [
    (['-k', '4'], 4, 0),
    (['--staging', 'packed32'], 4, 0),
    (['--staging', 'dict'], 4, 0),
    (['-k', '2', '--staging', 'dict'], 4, 0),
    (['--debug_nans'], 4, 0),
    (['--profile', '2'], 4, 3),
    (['-k', '2', '--profile', '2'], 2, 4),
], ids=['k4', 'packed32', 'dict', 'k2_dict', 'debug_nans', 'profile2',
        'k2_profile2'])
def test_train_cli_flag_matches_default_path(cache, small, tmp_path,
                                             tmp_path_factory, flags, steps,
                                             extra):
    """A flag's losses and final parameters equal the default path's, bit
    for bit. --profile N first takes one untraced step (block) and then
    ceil(N / K) traced ones: ``extra`` steps before the epoch, so the
    default run it is held against takes them too."""
    want_losses, want_params = _default_run(cache, tmp_path_factory,
                                            steps + extra)
    exp = str(tmp_path / 'exp')
    result = _train(cache, exp, ['-s', str(steps)] + flags)
    assert result['trainer'].step == steps + extra
    assert result['step_losses'] == want_losses[extra:]
    assert np.isfinite(result['step_losses']).all()
    for name, p in result['trainer'].model.named_parameters():
        torch.testing.assert_close(p.detach(), want_params[name], rtol=0,
                                   atol=0, msg=name)
    assert not torch.is_anomaly_enabled()
    if '--profile' in flags:
        path = os.path.join(exp, 'phase_1', 'profile', 'trace.json')
        assert result['profile'] == path
        with open(path) as f:
            events = json.load(f)['traceEvents']
        assert any(e.get('name', '').startswith('aten::') for e in events)
        # The program's spans, turned on for the profiled steps only.
        assert {'train.step', 'train.stage', 'train.forward',
                'model.forward', 'train.backward', 'train.update'} <= {
                    e.get('name') for e in events}
        assert not tracing.enabled()
    assert os.path.isfile(os.path.join(exp, 'phase_1', 'last_iter',
                                       'ckpt.pt'))


def test_train_cli_warns_on_a_partial_block(cache, small, tmp_path, caplog):
    result = _train(cache, str(tmp_path / 'exp'), ['-s', '3', '-k', '2'])
    assert len(result['step_losses']) == 2
    assert 'not divisible by steps_per_dispatch=2' in caplog.text
    with pytest.raises(SystemExit, match='exceeds'):
        _train(cache, str(tmp_path / 'exp2'), ['-s', '1', '-k', '2'])


def test_debug_nans_names_the_module(cache, small, tmp_path, monkeypatch):
    """A NaN put into one weight of the monophonic network's output layer:
    the library hooks and the CLI's --debug_nans both name that layer;
    the hooks come off after the run."""
    from ddsp_piano_torch import configs
    from ddsp_piano_torch.data.pipeline import get_dummy_data
    from ddsp_piano_torch.training import debug

    def poisoned(*a, **kw):
        model = small(*a, **{**SMALL, 'duration': SEGMENT_SECONDS, **kw})
        with torch.no_grad():
            model.monophonic_network.dense_out.kernel[0, 0] = float('nan')
        return model

    model = poisoned('maestro_v2', device='cpu')
    batch = {k: torch.from_numpy(v) for k, v in get_dummy_data(
        1, SEGMENT_SECONDS, 24000, n_synths=4).items()}
    handles = debug.enable_debug_nans(model)
    try:
        with pytest.raises(FloatingPointError,
                           match="'monophonic_network.dense_out'"):
            model(batch, training=True)
    finally:
        debug.disable_debug_nans(handles)
    assert not torch.is_anomaly_enabled()
    model(batch, training=True)   # no hooks left

    monkeypatch.setattr(configs, 'get_model', poisoned)
    with pytest.raises(FloatingPointError,
                       match="'monophonic_network.dense_out'"):
        _train(cache, str(tmp_path / 'exp'), ['-s', '2', '--debug_nans'])
    assert not torch.is_anomaly_enabled()


def test_recipe_runs_three_phases(cache, small, tmp_path):
    """python -m ddsp_piano_torch.train_ddsp_piano at -s 2 -e 1: phases 1,
    2 and 3 with train_ddsp_piano.sh's batch sizes and learning rates, each
    restored from the one before; phase 2 (maestro_v2's frequency modules
    are pretrained and frozen) keeps phase 1's weights. Run again, every
    phase finds itself done."""
    from ddsp_piano_torch import train_ddsp_piano as recipe

    exp = str(tmp_path / 'exp')
    args = recipe.process_args(['-s', '2', '-e', '1', '--device', 'cpu',
                                cache, exp])
    assert args.config == 'maestro_v2'
    assert recipe.process_args([cache, exp]).steps_per_epoch == 15904
    assert [recipe.phase_argv(args, *p)[3:10:2] for p in recipe.PHASES] == [
        ['1', '6', '1', '0.001'], ['2', '3', '1', '1e-05'],
        ['3', '6', '1', '0.001']]
    results = recipe.main(args)
    assert [r['trainer'].step for r in results] == [2, 4, 6]
    assert [r['trainer'].optimizer is None for r in results] == [
        False, True, False]
    saved = [torch.load(os.path.join(exp, f'phase_{p}', 'last_iter',
                                     'ckpt.pt'), weights_only=True)
             for p in (1, 2, 3)]
    for name, value in saved[0]['model'].items():
        torch.testing.assert_close(saved[1]['model'][name], value, rtol=0,
                                   atol=0)
    assert any(not torch.equal(saved[2]['model'][n], v)
               for n, v in saved[1]['model'].items())
    for r in results:
        assert len(r['step_losses']) == 2
        assert np.isfinite(r['step_losses']).all()
    again = recipe.main(args)
    assert [r['step_losses'] for r in again] == [[], [], []]


def test_gin_test_on_cpu(small, capsys, tmp_path):
    """python -m ddsp_piano_torch.configs.gin_test maestro_v2 --device cpu:
    the parameters by slot, a forward on get_dummy_data and one training
    step; a .gin path builds and steps too."""
    from ddsp_piano_torch.configs import gin_test

    result = gin_test.main(gin_test.process_args(
        ['maestro_v2', '--device', 'cpu', '--duration', '0.5']))
    out = capsys.readouterr().out
    model = small('maestro_v2', device='cpu', duration=0.5, **SMALL)
    assert sum(result['slots'].values()) == sum(
        p.numel() for p in model.parameters())
    assert 'monophonic_network' in result['slots']
    assert result['audio_shape'] == (2, 12000)
    assert np.isfinite(result['step_losses']['total_loss'])
    assert 'forward ok' in out and 'train step ok on cpu' in out
    from test_torch_gin import write_gin

    path = write_gin(tmp_path / 'model.gin')
    result = gin_test.main(gin_test.process_args(
        [path, '--device', 'cpu', '--duration', '0.5']))
    assert 'background_noise_model' in result['slots']
    assert result['audio_shape'] == (2, 8000)
    assert np.isfinite(result['step_losses']['total_loss'])
