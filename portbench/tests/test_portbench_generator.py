"""The traffic generator repeats by seed and asks every seed for the same
work."""

import json

import numpy as np
import pytest

from portbench import generator, harness

MIXES = sorted(p.stem for p in (harness.BENCH_DIR / 'traffic').glob('*.json'))


def _mix(name, **small):
    mix = json.loads((harness.BENCH_DIR / 'traffic'
                      / f'{name}.json').read_text())
    mix.update(small)
    return mix


@pytest.mark.parametrize('name', MIXES)
def test_same_seed_same_batches(name):
    mix = _mix(name, seconds_per_row=2.0)
    a = generator.batches(mix, 2, 250, 2 ** 31 + 7)
    b = generator.batches(mix, 2, 250, 2 ** 31 + 7)
    c = generator.batches(mix, 2, 250, 2 ** 31 + 8)
    for x, y in zip(a, b):
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])
    assert not np.array_equal(a[0]['roll'], c[0]['roll'])


@pytest.mark.parametrize('name', MIXES)
def test_every_seed_the_same_rates(name):
    mix = _mix(name)
    rates = [np.sort(generator.row_rates(mix, 48, np.random.default_rng(s)))
             for s in (1, 2)]
    np.testing.assert_array_equal(*rates)


def test_rows_follow_the_mix():
    mix = _mix('serve_b8_10s', seconds_per_row=10.0)
    batch = generator.batches(mix, 1, 250, 3)[0]
    roll = batch['roll']
    assert roll.shape == (8, 2500, 88, 2) and roll.dtype == np.float32
    assert set(np.unique(roll[..., 0])) <= {0.0, 1.0}
    onsets = (np.diff(roll[..., 0], axis=1, prepend=0) > 0).sum((1, 2))
    assert np.all(onsets >= 30) and np.all(onsets <= 160)
    assert np.all(roll[..., 1] <= 110 / 127 + 1e-6)
    assert set(np.unique(batch['pedal'][..., 0])) == {0.0, 127 / 128}
    assert np.all(batch['piano_model'] >= 0) and np.all(
        batch['piano_model'] < 10)
