'''
The import check: top-level module names compared whole, so the program
(``kvarq_tpu_torch``) passes where the JAX package (``kvarq_tpu``) does
not; and no file of the benchmark imports JAX or the JAX package, nor
does the reference import anything of the program.
'''

import ast
import os
import types

import pytest

from perfbench.lib import harness, spec

HERE = os.path.join(spec.ROOT, 'perfbench')
PROGRAM = types.ModuleType('kvarq_tpu_torch')


@pytest.mark.parametrize('modules,found', [
    ({'kvarq_tpu_torch': PROGRAM, 'kvarq_tpu_torch.engine': 1}, []),
    ({'kvarq_tpu': 1, 'kvarq_tpu.engine': 1}, ['kvarq_tpu',
                                              'kvarq_tpu.engine']),
    ({'jax': 1, 'jax.numpy': 1, 'jaxlib': 1}, ['jax', 'jax.numpy', 'jaxlib']),
    ({'flax.linen': 1}, ['flax.linen']),
    ({'bench': 1, 'benchmark': 1, 'perfbench.lib': 1}, ['bench']),
    ({'jax_fake': 1, 'kvarq_tpu_torchy': 1}, []),
    ({'kvarq': PROGRAM, 'kvarq_tpu_torch': PROGRAM}, []),
    ({'kvarq': types.ModuleType('kvarq'), 'kvarq_tpu_torch': PROGRAM},
     ['kvarq']),
], ids=['program', 'jax-package', 'jax', 'flax', 'bench', 'prefixes',
        'program-binding', 'other-kvarq'])
def test_forbidden_modules_by_whole_top_level_name(modules, found):
    assert harness.forbidden_modules(modules) == found


def _imports(path):
    with open(path) as fd:
        tree = ast.parse(fd.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split('.')[0]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            yield node.module.split('.')[0]


def _sources(*parts):
    for d, _, files in os.walk(os.path.join(HERE, *parts)):
        for f in files:
            if f.endswith('.py'):
                yield os.path.join(d, f)


def test_no_benchmark_file_imports_jax_or_the_jax_package():
    for path in _sources():
        assert not set(_imports(path)) & set(harness.FORBIDDEN), path


@pytest.mark.parametrize('rel,banned', [
    ('lib/refengine.py', {'torch'}), ('lib/check.py', {'torch'}),
    ('reference/MTBC.py', {'torch'}),
    # plain torch, on the card where the run has one
    ('lib/refexhaustive.py', set())])
def test_the_reference_imports_nothing_of_the_program(rel, banned):
    got = set(_imports(os.path.join(HERE, rel)))
    assert not got & ({'kvarq_tpu_torch', 'kvarq'} | banned), got
