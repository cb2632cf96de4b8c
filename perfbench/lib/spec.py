'''
``BENCHMARK.json`` and the files it names, found by name: a cell's
configuration (``perfbench/configs/<config>.json``), its traffic
(``perfbench/traffic/<traffic>.json``) and each metric's reader
(``perfbench/metrics/<metric>.py``, a ``read(record)`` that returns the
metric's value, or None where the run holds nothing to read).
'''

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def load(root=ROOT):
    with open(os.path.join(root, 'BENCHMARK.json')) as fd:
        return json.load(fd)


def cell(spec, name):
    for w in spec['workloads']:
        if w['name'] == name:
            return w
    raise KeyError('no workload %r in BENCHMARK.json' % name)


def config(name):
    with open(os.path.join(HERE, 'configs', name + '.json')) as fd:
        return json.load(fd)


def traffic(name):
    with open(os.path.join(HERE, 'traffic', name + '.json')) as fd:
        return json.load(fd)


def metrics(spec, cell_name, per_layer):
    ''' the metrics a cell reports: end-to-end without a trace, per-layer
        with one '''
    group = spec['per_layer' if per_layer else 'end_to_end']
    return [m for m in group
            if cell_name in m.get('workloads', [cell_name])]


def reader(name):
    ''' the ``read(record)`` of metric ``name`` '''
    path = os.path.join(HERE, 'metrics', name + '.py')
    mod_name = 'perfbench_metric_' + name.replace('.', '_').replace('-', '_')
    loader = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(loader)
    loader.loader.exec_module(module)
    return module.read
