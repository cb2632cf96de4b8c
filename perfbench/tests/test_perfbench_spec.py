'''
``BENCHMARK.json`` and the files it names: names and units of the allowed
characters and lengths, every file found by name, and every cell that
reports a per-layer metric reports the end-to-end metric it moves.
'''

import json
import os
import re

import pytest

from perfbench.lib import spec

ROOT = spec.ROOT
BENCH = spec.load()
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.\-]{1,16}$')
PATH = re.compile(r'^[A-Za-z0-9_.\-/]{1,200}$')
METRICS = BENCH['end_to_end'] + BENCH['per_layer']
KEYS = {
    'config': {'name', 'source', 'file', 'reduced', 'why'},
    'workload': {'name', 'config', 'traffic', 'chips', 'why'},
    'end_to_end': {'name', 'unit', 'better', 'bound', 'source'},
    'per_layer': {'name', 'unit', 'better', 'source', 'layer', 'moves'},
}


def line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 \
        and '\n' not in text and '\t' not in text


def test_top_level_keys_and_size():
    assert set(BENCH) == {'command', 'paths', 'run_seconds', 'configs',
                          'workloads', 'end_to_end', 'per_layer'}
    assert os.path.getsize(os.path.join(ROOT, 'BENCHMARK.json')) <= 64 * 1024
    assert 1 <= len(BENCH['command']) <= 32
    assert all(line(w) for w in BENCH['command'])
    assert 1 <= len(BENCH['paths']) <= 16
    for p in BENCH['paths']:
        assert PATH.match(p) and not p.startswith('/') and '..' not in p
    for w in BENCH['command'][1:]:
        if '/' in w:
            assert any(w.startswith(p + '/') for p in BENCH['paths'])
    assert isinstance(BENCH['run_seconds'], int)
    assert 1 <= BENCH['run_seconds'] <= 51


def test_a_full_check_with_24_cells_fits():
    runs = 2 + 14 * 24
    total = runs * (BENCH['run_seconds'] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


@pytest.mark.parametrize('kind', ['config', 'workload', 'end_to_end',
                                  'per_layer'])
def test_entry_keys_and_names(kind):
    group = {'config': BENCH['configs'], 'workload': BENCH['workloads'],
             'end_to_end': BENCH['end_to_end'],
             'per_layer': BENCH['per_layer']}[kind]
    names = [e['name'] for e in group]
    assert len(names) == len(set(names))
    for e in group:
        extra = {'workloads'} if kind in ('end_to_end', 'per_layer') else set()
        assert KEYS[kind] <= set(e) <= KEYS[kind] | extra, e
        assert NAME.match(e['name']), e['name']
        if 'unit' in e:
            assert UNIT.match(e['unit']), e['unit']
            assert e['better'] in ('lower', 'higher')
        for key in ('why', 'layer', 'source'):
            if key in e and kind != 'end_to_end' and kind != 'per_layer':
                assert line(e[key])
        if 'layer' in e:
            assert line(e['layer'])


def test_metric_names_unique_over_both_groups():
    names = [m['name'] for m in METRICS]
    assert len(names) == len(set(names))


def test_sources_and_bounds():
    for m in BENCH['end_to_end']:
        assert m['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= m['bound'] <= 0.25
    for m in BENCH['per_layer']:
        assert m['source'] in ('device_trace', 'program_span',
                               'program_counter', 'host_clock')
    assert 'setup_s' in [m['name'] for m in BENCH['end_to_end']]


def test_configs_are_files_of_their_own_under_paths():
    files = [c['file'] for c in BENCH['configs']]
    assert len(files) == len(set(files))
    used = {w['config'] for w in BENCH['workloads']}
    for c in BENCH['configs']:
        assert c['name'] in used
        assert c['file'] == 'perfbench/configs/%s.json' % c['name']
        assert c['source'].startswith('https://')
        with open(os.path.join(ROOT, c['file'])) as fd:
            body = json.load(fd)
        assert body['reduced'] == c['reduced'] and len(c['reduced']) <= 16
        for key in c['reduced']:
            assert NAME.match(key)
        assert 'assumed' in body and line(body['source'])


def test_cells_name_existing_configs_traffic_and_chips():
    pairs = set()
    configs = {c['name'] for c in BENCH['configs']}
    for w in BENCH['workloads']:
        assert w['config'] in configs
        assert NAME.match(w['traffic'])
        assert os.path.exists(os.path.join(ROOT, 'perfbench', 'traffic',
                                           w['traffic'] + '.json'))
        assert w['chips'] in (1, 4) and line(w['why'])
        assert (w['config'], w['traffic']) not in pairs
        pairs.add((w['config'], w['traffic']))
    four = sum(w['chips'] == 4 for w in BENCH['workloads'])
    assert four <= max(1, len(BENCH['workloads']) // 4)


def test_every_metric_has_a_reader():
    for m in METRICS:
        assert callable(spec.reader(m['name'])), m['name']


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for w in BENCH['workloads']:
        e2e = [m['name'] for m in spec.metrics(BENCH, w['name'], False)]
        assert 'setup_s' in e2e and len(e2e) >= 2
        assert spec.metrics(BENCH, w['name'], True)


def test_per_layer_metrics_move_a_metric_of_their_cells():
    cells = {w['name'] for w in BENCH['workloads']}
    e2e = {m['name']: m for m in BENCH['end_to_end']}
    layers = {}
    for m in BENCH['per_layer']:
        assert m['moves'] in e2e
        for cell in m.get('workloads', cells):
            assert cell in cells
            reported = [x['name'] for x in spec.metrics(BENCH, cell, False)]
            assert m['moves'] in reported, (m['name'], cell)
        layers.setdefault(m['name'].split('.')[0], set()).add(m['layer'])
    # the metrics of one quantity name one layer, letter for letter
    assert all(len(v) == 1 for v in layers.values())


def test_command_names_the_runner():
    assert BENCH['command'] == ['python3', 'perfbench/run.py']
    assert os.path.exists(os.path.join(ROOT, 'perfbench', 'run.py'))


def test_files_under_paths_are_named_from_name_characters():
    for p in BENCH['paths']:
        for d, _, files in os.walk(os.path.join(ROOT, p)):
            if '__pycache__' in d:
                continue
            for f in files:
                rel = os.path.relpath(os.path.join(d, f), ROOT)
                assert PATH.match(rel), rel
