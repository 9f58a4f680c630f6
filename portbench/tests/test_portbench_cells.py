"""Each cell's run on the CPU at a small size, past the look for a card:
the reference agrees with the port's CPU path, and with the timed path
broken underneath ``correct`` comes out false, once for each fault the
cell can have."""

import dataclasses
import json
import sys
import types

import pytest
import torch

from ddsp_piano_torch.models import piano_model, serving
from ddsp_piano_torch.training import trainer as trainer_mod
from portbench import harness, run as run_py
from portbench.loops import serve, train

SEED = 2 ** 31 + 11
CPU = torch.device('cpu')


def small(name, ranks=1):
    """The cell at a small size; a training cell on ``ranks`` gloo ranks
    (the training loop's data-parallel path, one all-reduce a step)."""
    cell = harness.load_cell(name)
    mix = dict(cell.mix, seconds_per_row=0.4)
    if mix['loop'] == 'serve':
        mix.update(batch=2, pool_requests=2, check_requests=1)
    else:
        # Every row's pedal goes down at once, so that the packed wire
        # format chosen from the first batch fits the later ones.
        mix.update(batch=2 * ranks, ranks=ranks, pool_batches=4,
                   seconds_per_row=0.2 if ranks > 1 else 0.4,
                   pedal=dict(mix['pedal'], up_s=[0.0, 0.05]))
    return dataclasses.replace(cell, mix=mix)


def run(name, ranks=1, **kw):
    cell = small(name, ranks)
    loop = serve if cell.mix['loop'] == 'serve' else train
    return loop.run(cell, SEED, 3.0, False, harness.Clock(), CPU, **kw)


@pytest.mark.parametrize('name', ['v2.serve-b8', 'dafx22.serve-b8'])
def test_serve_agrees_with_the_reference(name):
    result, checks = run(name)
    assert result['correct'] and result['attempted'] >= 2
    assert checks['audio_gap'][0] <= 1e-6


def _altered(make):
    def make_serving_fn(model, seed=0):
        inner = make(model, seed)

        def serve_fn(*args, **kwargs):
            out = inner(*args, **kwargs).clone()
            out[0, out.shape[1] // 2] += 0.01 * out[0].abs().max()
            return out
        return serve_fn
    return make_serving_fn


def _half_rows(make):
    def make_serving_fn(model, seed=0):
        inner = make(model, seed)

        def serve_fn(*args, **kwargs):
            out = inner(*args, **kwargs).clone()
            out[out.shape[0] // 2:] = 0.0
            return out
        return serve_fn
    return make_serving_fn


@pytest.mark.parametrize('fault', [_altered, _half_rows])
def test_serve_fault_is_not_correct(monkeypatch, fault):
    monkeypatch.setattr(serving, 'make_serving_fn',
                        fault(serving.make_serving_fn))
    result, checks = run('v2.serve-b8')
    assert not result['correct']
    assert checks['audio_gap'][0] > checks['audio_gap'][1]


def test_train_agrees_with_the_reference():
    result, checks = run('v2.train-b6')
    assert result['correct']
    for value, limit in checks.values():
        assert value <= 1e-6


def _half_batch_forward(forward):
    def half(self, features, noise=None, generator=None, training=False,
             **kw):
        if training:
            b = features['conditioning'].shape[0]
            features = {k: v[:b // 2] for k, v in features.items()}
            noise = noise.reshape(self.n_synths, b, -1)[:, :b // 2].reshape(
                self.n_synths * (b // 2), -1)
        return forward(self, features, noise=noise, generator=generator,
                       training=training, **kw)
    return half


def test_train_fault_state_unchanged(monkeypatch):
    monkeypatch.setattr(trainer_mod.Trainer, 'apply_gradients',
                        lambda self: None)
    result, checks = run('v2.train-b6')
    assert not result['correct']
    assert checks['update_median_gap'][0] > checks['update_median_gap'][1]


def test_train_fault_half_batch(monkeypatch):
    monkeypatch.setattr(piano_model.PianoModel, 'forward',
                        _half_batch_forward(piano_model.PianoModel.forward))
    result, checks = run('v2.train-b6')
    assert not result['correct']


def test_train_fault_gradient_ascent(monkeypatch):
    clip = trainer_mod.Trainer.clip_gradients

    def ascend(self):
        clip(self)
        for p in self.params:
            if p.grad is not None:
                p.grad.neg_()
    monkeypatch.setattr(trainer_mod.Trainer, 'clip_gradients', ascend)
    result, checks = run('v2.train-b6')
    assert not result['correct']
    assert checks['step_gap'][0] > 1.9


def test_train_fault_learning_rate(monkeypatch):
    make = trainer_mod.Trainer._make_optimizer

    def faster(self):
        optimizer = make(self)
        for group in optimizer.param_groups:
            group['lr'] *= 1.4
        return optimizer
    monkeypatch.setattr(trainer_mod.Trainer, '_make_optimizer', faster)
    result, checks = run('v2.train-b6')
    assert not result['correct']
    assert checks['step_gap'][0] > checks['step_gap'][1]


def one_thread_rank(*args):
    torch.set_num_threads(1)
    return train._rank(*args)


def test_data_parallel_agrees_with_the_reference():
    result, checks = run('v2.train-b6', ranks=2, rank_fn=one_thread_rank)
    assert result['correct'] and result['forbidden'] == []
    for value, limit in checks.values():
        assert value <= 1e-5


def jax_rank(*args):
    """A rank that has loaded a module named jax."""
    sys.modules['jax'] = types.ModuleType('jax')
    return one_thread_rank(*args)


def test_jax_in_a_rank_prints_no_result(capsys):
    result, checks = run('v2.train-b6', ranks=2, rank_fn=jax_rank)
    assert result['forbidden'] == ['jax']
    assert 'jax' not in sys.modules
    capsys.readouterr()
    assert run_py.report(result, checks) == 3
    out, err = capsys.readouterr()
    assert out == '' and "['jax']" in err


def test_report_prints_the_result_line(capsys):
    result, checks = run('v2.serve-b8')
    assert run_py.report(result, checks) == 0
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert line['correct'] and list(line)[-1] == 'checks'
    assert 'forbidden' not in line


class _NoExchange:
    """torch.distributed with an all-reduce that leaves each rank's
    buffer as it is."""

    def __getattr__(self, name):
        return getattr(torch.distributed, name)

    @staticmethod
    def all_reduce(tensor, *args, **kwargs):
        return None


def no_exchange_rank(*args):
    trainer_mod.dist = _NoExchange()
    return one_thread_rank(*args)


def test_data_parallel_fault_no_exchange():
    result, checks = run('v2.train-b6', ranks=2, rank_fn=no_exchange_rank)
    assert not result['correct']
