"""BENCHMARK.json and every file it names: each cell, configuration, mix,
limit and metric resolves by name, within the contract's limits."""

import json
import re

import pytest

from portbench import harness

SPEC = json.loads((harness.ROOT / 'BENCHMARK.json').read_text())
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
E2E = {m['name']: m for m in SPEC['end_to_end']}
CELLS = [w['name'] for w in SPEC['workloads']]


def test_top_level_keys():
    assert set(SPEC) == {'command', 'paths', 'run_seconds', 'configs',
                         'workloads', 'end_to_end', 'per_layer'}
    assert SPEC['paths'] == ['portbench']
    assert 1 <= SPEC['run_seconds'] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_names_units_and_keys():
    keys = {'configs': {'name', 'source', 'file', 'reduced', 'why'},
            'workloads': {'name', 'config', 'traffic', 'chips', 'why'},
            'end_to_end': {'name', 'unit', 'better', 'bound', 'source',
                           'workloads'},
            'per_layer': {'name', 'unit', 'better', 'source', 'layer',
                          'moves', 'workloads'}}
    for group, allowed in keys.items():
        names = [e['name'] for e in SPEC[group]]
        assert len(set(names)) == len(names)
        for e in SPEC[group]:
            assert set(e) <= allowed, (group, e)
            assert NAME.match(e['name'])
            if 'unit' in e:
                assert UNIT.match(e['unit']) and e['better'] in (
                    'lower', 'higher')
    for m in SPEC['end_to_end']:
        assert m['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= m['bound'] <= 0.25
    assert 'setup_s' in E2E and 'workloads' not in E2E['setup_s']
    assert sum(w['chips'] == 4 for w in SPEC['workloads']) <= max(
        1, len(CELLS) // 4)


@pytest.mark.parametrize('cell', CELLS)
def test_cell_resolves(cell):
    c = harness.load_cell(cell)
    assert c.config['reduced'] == []
    assert c.mix['loop'] in ('serve', 'train')
    assert c.limits and all(v > 0 for v in c.limits.values())
    names = {m['name'] for m in c.end_to_end}
    assert 'setup_s' in names and len(names) >= 2
    assert c.per_layer


@pytest.mark.parametrize('metric', [m['name'] for m in SPEC['per_layer']])
def test_metric_reader_and_what_it_moves(metric):
    m = {x['name']: x for x in SPEC['per_layer']}[metric]
    assert callable(harness.metric_reader(metric))
    moved = E2E[m['moves']]
    for cell in m['workloads']:
        assert cell in moved.get('workloads', CELLS)


def test_config_files():
    for c in SPEC['configs']:
        data = json.loads((harness.ROOT / c['file']).read_text())
        assert data['registry_name'] == c['name']
        assert data['source'] == c['source']
        assert data['reduced'] == c['reduced']
