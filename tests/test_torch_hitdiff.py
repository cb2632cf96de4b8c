'''
The port's hit-level harness ``kvarq_tpu_torch.tools.hitdiff`` on the
CPU: its own copy of the C reference has tools/ref_bench.c's code byte
for byte, and ``run_case`` holds the port's ``findseqs`` hit stream
equal, tuple for tuple and in order, to ref_bench's on the fixture sweep
(templates of 3-4 bases, maxerrors 0-3, minoverlap 3, 10, 20) and the
``--quick`` random corpora (N reads included, and a bank with N bases),
on the device path on the CPU, on the numpy backend and through the
screening matcher with the candidate screen's plain version (whose
thresholds reach 0 and below there).  A differing stream fails with its
first differing hit.
'''

import json
import os

import pytest

from kvarq_tpu_torch import engine as tengine
from kvarq_tpu_torch.engine import match_pallas
from kvarq_tpu_torch.tools import hitdiff

HERE = os.path.abspath(os.path.dirname(__file__))
ROOT = os.path.dirname(HERE)


@pytest.fixture(autouse=True)
def reset_torch_engine_config():
    tengine.config(maxerrors=0, minoverlap=20, minreadlength=10,
                   nthreads=1, Amin='!', Azero='!', device='cpu',
                   backend='device', mesh='', sieve='auto', batchsize=16384)
    yield
    tengine.config(backend='device')


@pytest.fixture(scope='module')
def ref_bin(tmp_path_factory):
    binpath = hitdiff.build_ref_bench(str(tmp_path_factory.mktemp('ref')))
    if binpath is None:
        pytest.skip('no C compiler available')
    return binpath


def _code(path):
    ''' a C file after its opening comment '''
    with open(path) as f:
        text = f.read()
    assert text.startswith('/*')
    return text[text.index('*/'):]


def test_ref_bench_source_is_a_copy():
    ''' the port's C reference is tools/ref_bench.c's code byte for byte
        (its opening comment names the reference's source without a
        machine path) '''
    want = _code(os.path.join(ROOT, 'tools', 'ref_bench.c'))
    assert _code(hitdiff.SOURCE) == want and len(want) > 5000


def _quick_cases(tmp_path, group):
    cases = list(hitdiff.cases(str(tmp_path), quick=True))
    fixture = [c for c in cases if c[0] == hitdiff.FIXTURE]
    assert len(fixture) == 12 and len(cases) == 40
    return fixture if group == 'fixture' else \
        [c for c in cases if c[0] != hitdiff.FIXTURE]


@pytest.mark.parametrize('group', ['fixture', 'random'])
@pytest.mark.parametrize('path', ['cpu', 'numpy', 'screen'])
def test_run_case_sweep(path, group, ref_bin, tmp_path, monkeypatch):
    ''' every quick-sweep case's hit stream equals ref_bench's; ``screen``
        runs the screening matcher (the card's) with the plain screen '''
    if path == 'screen':
        monkeypatch.setattr(
            tengine, '_make_matcher',
            lambda seqs: match_pallas.PallasMatcher(
                seqs, tengine._config['maxerrors'],
                tengine._config['minoverlap'], 'cpu'))
    total = 0
    for case in _quick_cases(tmp_path, group):
        total += hitdiff.run_case(
            ref_bin, *case, str(tmp_path), device='cpu',
            backend='numpy' if path == 'numpy' else 'device')
    assert total > 1000


def test_run_case_shows_the_first_differing_hit(ref_bin, tmp_path,
                                                monkeypatch):
    ''' a stream with one hit dropped fails at that hit, with context '''
    case = next(iter(hitdiff.cases(str(tmp_path), quick=True)))
    want = hitdiff.ref_hits(ref_bin, *case, str(tmp_path))
    engine_hits = hitdiff.engine_hits

    def drop_third(*args):
        got = engine_hits(*args)
        return got[:3] + got[4:]

    monkeypatch.setattr(hitdiff, 'engine_hits', drop_third)
    with pytest.raises(AssertionError) as e:
        hitdiff.run_case(ref_bin, *case, str(tmp_path), device='cpu')
    msg = str(e.value)
    assert 'first divergence at 3' in msg
    assert 'ref=%s' % want[3] in msg
    assert '%d vs %d hits' % (len(want), len(want) - 1) in msg


def test_main_quick_on_the_cpu(capsys):
    ''' the tool's own run: exit 0, a JSON last line '''
    assert hitdiff.main(['--quick', '--device', 'cpu']) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out['cases'] == 40 and out['hits'] > 10000
    assert (out['device'], out['backend'], out['cand_launches']) == \
        ('cpu', 'device', 0)
