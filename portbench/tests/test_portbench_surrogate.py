"""The surrogate cell (surrogate.train-b6) on the CPU at a small size: it
agrees with the reference, a faulted step reads ``correct`` false, its
files and metric readers resolve, and its reference loads nothing of the
port or of JAX."""

import dataclasses
import json
import subprocess
import sys

import pytest
import torch

from ddsp_piano_torch.models import piano_model
from ddsp_piano_torch.processors import surrogate as port_surrogate
from ddsp_piano_torch.training import trainer as trainer_mod
from portbench import harness
from portbench.loops import train

CELL = 'surrogate.train-b6'
SEED = 2 ** 31 + 23
CPU = torch.device('cpu')


def run():
    """The cell at a small size: 2 rows of 0.4 s, a pool of 4 batches,
    every row's pedal down at once (the packed wire format chosen from the
    first batch fits the later ones)."""
    cell = harness.load_cell(CELL)
    mix = dict(cell.mix, batch=2, pool_batches=4, seconds_per_row=0.4,
               pedal=dict(cell.mix['pedal'], up_s=[0.0, 0.05]))
    cell = dataclasses.replace(cell, mix=mix)
    return train.run(cell, SEED, 3.0, False, harness.Clock(), CPU)


def test_cell_files_and_readers_resolve():
    cell = harness.load_cell(CELL)
    assert cell.chips == 1
    assert cell.config['registry_name'] == 'surrogate'
    assert cell.config['build']['n_instruments'] == 1
    assert cell.mix['piano_models'] == 1 and cell.mix['loop'] == 'train'
    assert set(cell.limits) == {'loss0_gap', 'step_gap',
                                'update_median_gap'}
    names = {m['name'] for m in cell.per_layer}
    assert {'surrogate_decay_roofline',
            'surrogate_decay_bwd_roofline'} <= names
    assert {m['name'] for m in cell.end_to_end} == {'train_segments_per_s',
                                                     'setup_s'}


@pytest.mark.parametrize('metric,kernel,bound', [
    ('surrogate_decay_roofline', 'void osc_decay_kernel(float const*)',
     'oscillator_skip'),
    ('surrogate_decay_bwd_roofline',
     'osc_decay_bwd_kernel(DecayBwdArgs, float const*)',
     'oscillator_skip_bwd')])
def test_decay_roofline_readers(metric, kernel, bound):
    """Each reader: nothing without its kernel (the program before K10 and
    K11), the least time over the profiler's seconds with it, and a raise
    when the profiler's events do not match the launch counter."""
    read = harness.metric_reader(metric)
    counter = {'oscillator_skip': 'oscillator_decay',
               'oscillator_skip_bwd': 'oscillator_decay_bwd'}[bound]
    trace = harness.Trace(kind='train', window_s=1.0, units=2,
                          bounds={bound: 0.001})
    assert read(trace) is None
    trace.device = {kernel: (0.004, 2), 'other_kernel': (1.0, 5)}
    trace.launches = {counter: 2}
    assert read(trace) == pytest.approx(25.0)
    trace.launches = {counter: 1}
    with pytest.raises(RuntimeError, match='counted launches'):
        read(trace)


def test_surrogate_agrees_with_the_reference():
    """Within a thousandth of each limit. The port's plain decay gradient
    is written out (ops.oscillator.render_framewise_decay_vjp) and the
    reference's is autograd of its expression, so the median leaf's change
    over three Adam steps reads ~5e-5 here, not the ~1e-7 of the cells
    whose two sides share their written-out gradients."""
    result, checks = run()
    assert result['correct']
    for value, limit in checks.values():
        assert value <= 1e-3 * limit


def test_fault_envelope_left_out(monkeypatch):
    """The port's decay render with every envelope 1."""
    render = port_surrogate.render_framewise_decay_skip

    def flat(controls, decays, decay_time, upsampling, sample_rate):
        return render(controls, torch.ones_like(decays), decay_time,
                      upsampling, sample_rate)
    monkeypatch.setattr(port_surrogate, 'render_framewise_decay_skip', flat)
    result, checks = run()
    assert not result['correct']
    assert checks['loss0_gap'][0] > checks['loss0_gap'][1]


def test_fault_gradient_ascent(monkeypatch):
    clip = trainer_mod.Trainer.clip_gradients

    def ascend(self):
        clip(self)
        for p in self.params:
            if p.grad is not None:
                p.grad.neg_()
    monkeypatch.setattr(trainer_mod.Trainer, 'clip_gradients', ascend)
    result, checks = run()
    assert not result['correct']
    assert checks['step_gap'][0] > 1.9


def test_fault_half_batch(monkeypatch):
    forward = piano_model.PianoModel.forward

    def half(self, features, noise=None, generator=None, training=False,
             **kw):
        if training:
            b = features['conditioning'].shape[0]
            features = {k: v[:b // 2] for k, v in features.items()}
            noise = noise.reshape(self.n_synths, b, -1)[:, :b // 2].reshape(
                self.n_synths * (b // 2), -1)
        return forward(self, features, noise=noise, generator=generator,
                       training=training, **kw)
    monkeypatch.setattr(piano_model.PianoModel, 'forward', half)
    result, checks = run()
    assert not result['correct']


def test_the_surrogate_reference_loads_nothing_of_the_port():
    probe = (f"import json, sys\nsys.path.insert(0, {str(harness.ROOT)!r})\n"
             "from portbench.reference import configs\n"
             "from portbench.reference.models import surrogate\n"
             "configs.get_model('surrogate', False, 0.2, 0, 'cpu')\n"
             "print(json.dumps(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, '-c', probe], capture_output=True,
                         text=True, check=True, timeout=300)
    top = {m.split('.')[0] for m in json.loads(out.stdout.splitlines()[-1])}
    assert not top & {'jax', 'jaxlib', 'flax', 'ddsp_piano_tpu',
                      'ddsp_piano_torch'}
