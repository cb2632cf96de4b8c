'''
End to end through the port: the Analyser and ``python -m
kvarq_tpu_torch.cli scan`` on the MTBC fixtures give the reference's
golden calls and the same coverages/analyses/stats as kvarq_tpu's numpy
hit path, ``-H``/``-x``/``--profile`` give kvarq_tpu's hits, extracted
records and phases; the package runs with jax absent.
'''

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from kvarq_tpu import analyse as janalyse
from kvarq_tpu import cli as jcli
from kvarq_tpu import engine as jengine
from kvarq_tpu.fastq import Fastq
from kvarq_tpu.log import set_warning
from kvarq_tpu.testsuites import discover_testsuites, load_testsuites
from kvarq_tpu_torch import analyse, cli
from kvarq_tpu_torch import engine as tengine
from kvarq_tpu_torch import testsuites as ttestsuites
from kvarq_tpu_torch.engine import tensor_scan as tts
from kvarq_tpu_torch.fastq import Fastq as TFastq

from _torch_log import restore_log_levels  # noqa: F401

HERE = os.path.abspath(os.path.dirname(__file__))
ROOT = os.path.dirname(HERE)
TESTSUITES = os.path.join(ROOT, 'testsuites')
FASTQ1 = os.path.join(HERE, 'fastqs', 'L3_N1014_hits_5k.fastq')
FASTQ2 = os.path.join(HERE, 'fastqs', 'N0116_1_hits_1k.fastq')

needs_genome = pytest.mark.skipif(
    not os.path.exists(os.path.join(TESTSUITES, 'MTBC',
                                    'MTB_ancestor_reference.bases')),
    reason='run tools/reconstruct_genome.py first')


@pytest.fixture(autouse=True)
def reset_torch_engine_config():
    ''' every test starts from the port engine's built-in defaults, and
        leaves the device path as the backend '''
    tengine.config(maxerrors=0, minoverlap=20, minreadlength=10,
                   nthreads=1, Amin='!', Azero='!', device='cpu',
                   backend='device',
                   sieve=os.environ.get('KVARQ_SIEVE', 'auto'),
                   batchsize=int(os.environ.get('KVARQ_BATCHSIZE', '16384')))
    yield
    tengine.config(backend='device')


def _mtbc():
    set_warning()
    return load_testsuites(discover_testsuites([TESTSUITES]), ['MTBC'])


def _port_mtbc():
    ''' the MTBC testsuites loaded through the port '''
    return ttestsuites.load_testsuites(
        ttestsuites.discover_testsuites([TESTSUITES]), ['MTBC'])


@needs_genome
@pytest.mark.parametrize('sieve', ['auto', 'off'])
def test_analyser_matches_numpy_hit_path(sieve, monkeypatch):
    ''' unsieved, steps above 64 reads screen (below the fixture's read
        count), so the scan runs the candidate screen on the full MTBC
        bank '''
    if sieve == 'off':
        monkeypatch.setattr(tts.TensorScanner, 'SCREEN_MIN_ROWS', 64)
    suites = _mtbc()
    fastq = Fastq(FASTQ2, quiet=True)
    params = dict(maxerrors=2, minoverlap=25, minreadlength=25,
                  Amin=fastq.Q2A(13), Azero=fastq.Azero)

    jengine.config(backend='numpy', nthreads=1, **params)
    ref = janalyse.Analyser()
    ref.scan(fastq, suites, keep_hits=True)
    ref.update_testsuites()

    tengine.config(sieve=sieve, **params)
    got = analyse.Analyser()
    got.scan(TFastq(FASTQ2, quiet=True), _port_mtbc(), keep_hits=False)
    got.update_testsuites()

    assert got.hits is None
    assert got.config == tengine.get_config()
    for name in ref.coverages:
        assert ref.coverages[name].serialize() == \
            got.coverages[name].serialize(), name
    assert got.stats == ref.stats
    assert got.results == ref.results
    e1, e2 = ref.encode(), got.encode()
    for k in ('analyses', 'stats', 'coverages'):
        assert e1[k] == e2[k]
    assert e2['info']['config'] == tengine.get_config()


def _scan_illustrate(capsys, tmp_path, fastq, params=()):
    out = str(tmp_path / 'out.json')
    cli.main(['-q', '-t', TESTSUITES, 'scan', '-l', 'MTBC', '-f',
              '--backend', 'cpu', *params, fastq, out])
    capsys.readouterr()
    cli.main(['-q', '-t', TESTSUITES, 'illustrate', '-r', out])
    return capsys.readouterr().out


@needs_genome
def test_cli_golden(capsys, tmp_path):
    ''' golden end-to-end (mirror of tests/test_cli.py::test_scan_illustrate) '''
    out = _scan_illustrate(capsys, tmp_path, FASTQ1,
                           ['--variant', 'Illumina 1.8+'])
    for call in [
            'Streptomycin resistance::SNP781687AG=rpsL.K43R',
            'Ethambutol resistance::SNP4247431GT=embB.M306I',
            'Isoniazid resistance [2155168CG=katG.S315T]',
            'Rifampicin resistance (RRDR) '
            '[761139CG=rpoB.H445D 761140AG=rpoB.H445R]',
            'remark: low coverage (RRDR below 10x)',
            'lineage 3']:
        assert call in out, call

    out = _scan_illustrate(capsys, tmp_path, FASTQ2)
    for call in ['Streptomycin resistance::SNP781687AG=rpsL.K43R',
                 'remark: low coverage (RRDR below 10x)', 'lineage 2']:
        assert call in out, call


@pytest.mark.parametrize('args', [
    ['scan', '--backend', 'xla'], ['scan', '--backend', 'pallas'],
    ['scan', '--backend', 'numpy'], ['scan', '--backend', 'auto']])
def test_cli_refuses_unported_options(args, tmp_path, capsys, monkeypatch):
    ''' kvarq_tpu's xla and pallas stay refused, each naming the port's
        counterpart (cpu, cuda); numpy and auto are ported: numpy scans on
        the host, and auto, with ``torch.cuda.is_available()`` False, fails
        as the default scan does, before scanning '''
    backend = args[2]
    out = tmp_path / 'out.json'
    args = args + ['-l', 'MTBC', '-f', FASTQ2, str(out)]
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    if backend == 'numpy':
        cli.main(['-q', '-t', TESTSUITES] + args)
        assert json.load(open(out))['stats']['records_parsed'] == 250
        return
    with pytest.raises(SystemExit) as e:
        cli.main(args)
    assert e.value.code != 0
    err = capsys.readouterr().err
    assert 'not yet ported' not in err
    if backend == 'auto':
        assert 'torch.cuda.is_available() is False' in err
    else:
        assert "counterpart is --backend %s" % (
            'cpu' if backend == 'xla' else 'cuda') in err
    assert not out.exists()


def _scan_both(tmp_path, fastq, args, extra=()):
    ''' the same scan through kvarq_tpu's CLI (numpy backend) and the
        port's (CPU); ``args`` may name ``{dir}``, the run's own directory.
        :returns: both result dicts and run directories '''
    out = []
    # kvarq_tpu reads with one thread: its threaded reader can lose the
    # wake-up at the end of input
    for name, main, backend, threads in (
            ('ref', jcli.main, 'numpy', ['-t', '1']),
            ('port', cli.main, 'cpu', [])):
        d = tmp_path / name
        d.mkdir()
        main(['-q', '-t', TESTSUITES, 'scan', *threads, '-l', 'MTBC', '-f',
              '--backend', backend, *extra,
              *[a.format(dir=d) for a in args], fastq, str(d / 'out.json')])
        with open(d / 'out.json') as fd:
            out.append((json.load(fd), d))
    return out


@needs_genome
@pytest.mark.parametrize('fastq,extra', [
    (FASTQ1, ['--variant', 'Illumina 1.8+']), (FASTQ2, [])])
def test_cli_hits_match_kvarq_tpu(fastq, extra, tmp_path):
    ''' -H: the result json, hits included, equals kvarq_tpu's '''
    (ref, _), (got, _) = _scan_both(tmp_path, fastq, ['-H'], extra)
    assert len(got['hits']) > 0
    for key in ('coverages', 'analyses', 'stats', 'hits', 'hitseqs'):
        assert got[key] == ref[key], key
    assert ref['info']['config']['nthreads'] == 1
    assert got['info']['config'] == dict(ref['info']['config'], nthreads=8)


@needs_genome
def test_cli_extract_hits_match_kvarq_tpu(tmp_path, capsys):
    ''' -x: the extracted FastQ records are byte-equal to kvarq_tpu's,
        and an existing file is not overwritten without -f '''
    (ref, rdir), (got, pdir) = _scan_both(tmp_path, FASTQ2,
                                          ['-x', '{dir}/hits.fastq'])
    assert 'hits' not in got
    data = (pdir / 'hits.fastq').read_bytes()
    assert data == (rdir / 'hits.fastq').read_bytes()
    # one four-line record per hit
    assert data.count(b'\n') == 4 * sum(got['stats']['nseqhits']) > 0

    with pytest.raises(SystemExit) as e:
        cli.main(['-q', '-t', TESTSUITES, 'scan', '-l', 'MTBC', '--backend',
                  'cpu', '-x', str(pdir / 'hits.fastq'), FASTQ2,
                  str(pdir / 'new.json')])
    assert e.value.code == jcli.ERROR_FILE_EXISTS
    assert not (pdir / 'new.json').exists()
    assert (pdir / 'hits.fastq').read_bytes() == data


@needs_genome
def test_cli_profile_phases(tmp_path):
    ''' --profile DIR: info.phases with kvarq_tpu's keys, and a
        torch.profiler trace in DIR '''
    (ref, _), (got, pdir) = _scan_both(tmp_path, FASTQ2,
                                       ['--profile', '{dir}/trace'])
    phases = got['info']['phases']
    assert set(phases) == set(ref['info']['phases']) \
        == {'scan', 'analyse', 'total'}
    assert phases['total'] >= phases['scan'] >= 0
    for key in ('coverages', 'analyses', 'stats'):
        assert got[key] == ref[key], key
    from kvarq_tpu_torch.profiling import TRACE_FILE
    with open(pdir / 'trace' / TRACE_FILE) as fd:
        events = json.load(fd)['traceEvents']
    assert any('aten::' in str(ev.get('name')) for ev in events)


def test_runs_without_jax(tmp_path):
    ''' the port imports and scans, coverage path and ``scan -H -x``, with
        jax unimportable (the machine with the card has none) '''
    code = '''
import json, sys
sys.modules['jax'] = None
sys.modules['ml_dtypes'] = None
import kvarq_tpu_torch.cli
from kvarq_tpu_torch import engine
engine.config(device='cpu', maxerrors=1, minoverlap=10, minreadlength=5)
ret = engine.countseqs(sys.argv[1], ['CACCGGTGTAGGCAAGTCGTAACAAGG', 'CCC'])
kvarq_tpu_torch.cli.main(['-q', '-t', sys.argv[2], 'scan', '-l', 'MTBC/phylo',
                          '--backend', 'cpu', '-H', '-x', sys.argv[4],
                          sys.argv[3], sys.argv[5]])
assert not [m for m in sys.modules if m.startswith(('jax.', 'ml_dtypes.'))]
print(json.dumps({'stats': ret['stats'],
                  'basecounts': [b.tolist() for b in ret['basecounts']]}))
'''
    fastq = os.path.join(HERE, 'fastqs', 'test_engine.fastq')
    hits, out = str(tmp_path / 'hits.fastq'), str(tmp_path / 'out.json')
    proc = subprocess.run([sys.executable, '-c', code, fastq, TESTSUITES,
                           FASTQ2, hits, out], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])

    cli.main(['-q', '-t', TESTSUITES, 'scan', '-l', 'MTBC/phylo', '-f',
              '--backend', 'cpu', '-H', '-x', str(tmp_path / 'want.fastq'),
              FASTQ2, str(tmp_path / 'want.json')])
    with open(out) as a, open(tmp_path / 'want.json') as b:
        assert json.load(a)['hits'] == json.load(b)['hits']
    with open(hits, 'rb') as a, open(tmp_path / 'want.fastq', 'rb') as b:
        assert a.read() == b.read()

    tengine.config(maxerrors=1, minoverlap=10, minreadlength=5)
    want = tengine.countseqs(fastq, ['CACCGGTGTAGGCAAGTCGTAACAAGG', 'CCC'])
    assert got['stats'] == json.loads(json.dumps(want['stats']))
    for g, w in zip(got['basecounts'], want['basecounts']):
        np.testing.assert_array_equal(np.asarray(g), w)
    assert sum(want['stats']['nseqhits']) > 0
