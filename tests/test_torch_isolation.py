"""The port stands alone, and never falls back quietly to the CPU.

- Importing ddsp_piano_torch and every module under it, and chip_smoke.py,
  loads neither jax nor ddsp_piano_tpu, nor tensorflow, which the port
  imports only to read or write a TF checkpoint, nor tensorboard,
  google.protobuf or matplotlib; writing and reading a summaries event
  file and parsing a gin text load none of them either (checked in a
  fresh interpreter).
- An entry point called with no device on a host without CUDA raises.
- chip_smoke.py exits non-zero, printing no result, without a card and in
  a directory that holds nothing else of the repository.
"""

import os
import shutil
import subprocess
import sys

import pytest
import threadpoolctl

torch = pytest.importorskip('torch')
torch.set_num_threads(1)
# numpy's BLAS too, for the whole worker (xdist collects every file):
# threaded OpenBLAS stalls at each call's barrier on a loaded host.
threadpoolctl.threadpool_limits(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import ddsp_piano_torch
names = [m.name for m in pkgutil.walk_packages(ddsp_piano_torch.__path__,
                                                'ddsp_piano_torch.')]
for name in names:
    importlib.import_module(name)
import chip_smoke
import numpy as np, tempfile
from ddsp_piano_torch.configs import gin_compat
from ddsp_piano_torch.training import events, summaries
with tempfile.TemporaryDirectory() as logdir:
    writer = summaries.SummaryWriter(logdir)
    writer.scalar('loss', 1.0, 1)
    writer.audio('audio', np.zeros((1, 100), np.float32), 16000, 1)
    writer.image('image', np.zeros((4, 4, 3), np.uint8), 1)
    writer.flush()
    assert len(events.read_events(writer.path)) == 4
    writer.close()
gin_compat.parse_gin_string("n = 3\nFoo.x = [%n, @bar/Baz()]")
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'ddsp_piano_tpu',
                                    'tensorflow', 'tensorboard',
                                    'matplotlib')
             or m.startswith('google.protobuf'))
print(len(names), bad)
assert not bad, bad
assert len(names) >= 50, names
for name in ('models.streaming', 'processors.surrogate',
             'configs.enstdkcl_8khz', 'configs.enstdkcl_32khz',
             'configs.multi_instruments', 'configs.surrogate',
             'preprocess_maestro', 'train_ddsp_piano', 'training.staging',
             'training.debug', 'configs.gin_test', 'models.serving',
             'data.midi_encoders_device', 'kernels.voice_allocator',
             'synthesize_from_csv', 'training.events', 'training.summaries',
             'configs.gin_compat', 'models.default_model',
             'parallel.mesh', 'native', 'kernels.oscillator_decay'):
    assert 'ddsp_piano_torch.' + name in names, names
"""


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=ROOT, **extra)
    return env


def test_port_imports_no_jax_and_no_jax_package():
    proc = subprocess.run([sys.executable, '-c', _IMPORT_ALL], cwd=ROOT,
                          env=_env(), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_entry_points_raise_without_cuda(monkeypatch):
    from ddsp_piano_torch import synthesize_midi_file as cli
    from ddsp_piano_torch.configs import get_model

    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        get_model('maestro_v2', inference=True)
    for flags in ([], ['--streaming']):
        with pytest.raises(RuntimeError, match='CUDA is not available'):
            cli.main(cli.process_args(flags + ['in.mid', 'out.wav']))
    assert get_model('maestro_v2', device='cpu').device.type == 'cpu'


def test_evaluate_cli_raises_without_cuda(monkeypatch, tmp_path):
    from ddsp_piano_torch import evaluate_model as cli

    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        cli.main(cli.process_args([str(tmp_path), str(tmp_path / 'out')]))


def test_csv_cli_raises_without_cuda(monkeypatch, tmp_path):
    from ddsp_piano_torch import synthesize_from_csv as cli

    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        cli.main(cli.process_args([str(tmp_path), str(tmp_path / 'p.csv'),
                                   str(tmp_path / 'out')]))


def test_training_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    from ddsp_piano_torch import train_ddsp_piano, train_single_phase
    from ddsp_piano_torch.configs import gin_test

    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    paths = [str(tmp_path), str(tmp_path / 'exp')]
    for cli in (train_single_phase, train_ddsp_piano):
        with pytest.raises(RuntimeError, match='CUDA is not available'):
            cli.main(cli.process_args(paths))
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        gin_test.main(gin_test.process_args(['maestro_v2']))


def test_kernel_wrappers_refuse_what_they_cannot_take():
    from ddsp_piano_torch.kernels import gru, note_release, oscillator
    from ddsp_piano_torch.ops.oscillator import FramewiseOscControls

    x = torch.zeros(4, 2, 1)
    for wrapper in (note_release.note_release_scan_cuda,
                    note_release.note_release_scan_res_cuda):
        with pytest.raises(ValueError, match='CUDA'):
            wrapper(x, torch.ones(1), torch.zeros(2, 2))
    with pytest.raises(ValueError, match='CUDA'):
        note_release.note_release_scan_bwd_cuda(
            x, torch.ones(1), torch.zeros(4, 2), torch.zeros(4, 2), x,
            torch.zeros(2, 2))
    gru_args = (torch.zeros(3, 2, 12), torch.zeros(4, 12), torch.zeros(12),
                torch.zeros(2, 4))
    with pytest.raises(ValueError, match='CUDA'):
        gru.gru_scan_cuda(*gru_args)
    with pytest.raises(ValueError, match='CUDA'):
        gru.gru_scan_bwd_cuda(*gru_args, torch.zeros(3, 2, 4),
                              torch.zeros(3, 2, 4))
    controls = FramewiseOscControls(*(torch.zeros(1, 2, 8)
                                      for _ in range(5)))
    with pytest.raises(ValueError, match='CUDA'):
        oscillator.render_framewise_skip_cuda(controls, 96, 24000)
    with pytest.raises(ValueError, match='CUDA'):
        oscillator.render_framewise_skip_bwd_cuda(
            controls, torch.zeros(1, 192), 96, 24000)
    with pytest.raises(ValueError, match='CUDA'):
        oscillator.render_framewise_full_cuda(controls, 64, 16000)


@pytest.mark.parametrize('alone', [False, True], ids=['repo', 'alone'])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    cwd = ROOT
    env = _env(CUDA_VISIBLE_DEVICES='')
    if alone:
        cwd = str(tmp_path)
        shutil.copy(os.path.join(ROOT, 'chip_smoke.py'), cwd)
        env = dict(os.environ, CUDA_VISIBLE_DEVICES='')
        env.pop('PYTHONPATH', None)
    proc = subprocess.run([sys.executable, 'chip_smoke.py'], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
