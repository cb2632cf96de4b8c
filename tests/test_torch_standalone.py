'''
kvarq_tpu_torch stands alone: no module of the port, and not
``chip_smoke.py``, imports ``kvarq_tpu``, the ``kvarq`` alias package, the
root ``bench.py`` or ``jax``; with those names blocked the port imports
every module (the GUI's only where tkinter is installed) and runs
``scan -H -x`` and ``batch`` to kvarq_tpu's results; the MTBC testsuites load through both packages in one process,
in either order, each package getting its own classes; and the port's
copies of kvarq_tpu's host helpers (the corpus generator, the numpy
oracle matcher, the bank layout) give kvarq_tpu's results.
'''

import ast
import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from kvarq_tpu import cli as jcli
from kvarq_tpu import parallel as jparallel
from kvarq_tpu.engine import match_numpy as jmatch_numpy
from kvarq_tpu.engine import pallas_scan as jps
from kvarq_tpu.engine import tensor_scan as jts
from kvarq_tpu.engine.reader import RecordBatch
from kvarq_tpu_torch import bench as tbench
from kvarq_tpu_torch import parallel as tparallel

from _torch_log import restore_log_levels  # noqa: F401
from kvarq_tpu_torch.engine import encode as tencode
from kvarq_tpu_torch.engine import match_numpy as tmatch_numpy
from kvarq_tpu_torch.engine import pallas_scan as tps
from kvarq_tpu_torch.engine import tensor_scan as tts

from _torch_cases import case
from test_pallas_scan import _random_case

HERE = os.path.abspath(os.path.dirname(__file__))
ROOT = os.path.dirname(HERE)
TESTSUITES = os.path.join(ROOT, 'testsuites')
FASTQ1 = os.path.join(HERE, 'fastqs', 'L3_N1014_hits_5k.fastq')
FASTQ2 = os.path.join(HERE, 'fastqs', 'N0116_1_hits_1k.fastq')
# the names the port must never import
FORBIDDEN = ('kvarq_tpu', 'kvarq', 'bench', 'jax')

PORT_FILES = sorted(
    os.path.relpath(p, ROOT) for p in
    glob.glob(os.path.join(ROOT, 'kvarq_tpu_torch', '**', '*.py'),
              recursive=True)) + ['chip_smoke.py']


def _forbidden(name):
    return name.split('.')[0] in FORBIDDEN


@pytest.mark.parametrize('relpath', PORT_FILES)
def test_no_import_of_the_jax_package(relpath):
    ''' every import statement of the file, at any depth, and every string
        handed to a call (``importlib.import_module(...)``, ``python -m
        ...``) names none of FORBIDDEN '''
    with open(os.path.join(ROOT, relpath)) as fd:
        tree = ast.parse(fd.read(), relpath)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and not node.level:
            if _forbidden(node.module):
                bad.append(node.module)
        elif isinstance(node, ast.Call):
            for arg in node.args:
                bad += [c.value for c in ast.walk(arg)
                        if isinstance(c, ast.Constant)
                        and isinstance(c.value, str)
                        and c.value.startswith(('kvarq_tpu.', 'jax.'))]
    assert not bad, '%s imports %s' % (relpath, bad)


# --- the port with kvarq_tpu, kvarq and jax unimportable ---------------------

BLOCKED = r'''
import json, pkgutil, importlib, sys
for name in ('kvarq_tpu', 'kvarq', 'jax', 'bench'):
    sys.modules[name] = None
try:
    import tkinter
except ImportError:
    tkinter = None
import kvarq_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(kvarq_tpu_torch.__path__,
                                              'kvarq_tpu_torch.')]
for m in mods:
    # the GUI modules import tkinter, which a host may lack; the AST walk
    # above holds them to the rule all the same
    if tkinter is not None or not m.startswith('kvarq_tpu_torch.gui.'):
        importlib.import_module(m)
from kvarq_tpu_torch import cli
ts, fq, out, hits, batch = sys.argv[1:6]
cli.main(['-q', '-t', ts, 'scan', '-f', '-l', 'MTBC', '--backend', 'cpu',
          '-H', '-x', hits, fq, out])
cli.main(['-q', '-t', ts, 'batch', '-f', '-l', 'MTBC', '--backend', 'cpu',
          fq, batch])
leaked = sorted(m for m in sys.modules if m.split('.')[0] in
                ('kvarq_tpu', 'kvarq', 'jax', 'bench')
                and sys.modules[m] is not None)
print(json.dumps({'modules': mods, 'leaked': leaked}))
'''


def _json(path):
    with open(path) as fd:
        return json.load(fd)


def test_runs_with_the_jax_package_blocked(tmp_path):
    ''' every port module imports, and ``scan -H -x`` and ``batch`` run on
        the MTBC fixture, with kvarq_tpu, kvarq, jax and bench blocked in
        sys.modules; the jsons and extracted records equal kvarq_tpu's
        (numpy hit path for scan, its own batch) '''
    out, hits, batch = (str(tmp_path / n) for n in
                        ('scan.json', 'hits.fastq', 'batch.json'))
    proc = subprocess.run(
        [sys.executable, '-c', BLOCKED, TESTSUITES, FASTQ2, out, hits, batch],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    info = json.loads(proc.stdout.strip().splitlines()[-1])
    assert not info['leaked']
    assert {'kvarq_tpu_torch.cli', 'kvarq_tpu_torch.bench',
            'kvarq_tpu_torch.engine.native', 'kvarq_tpu_torch.genes',
            'kvarq_tpu_torch.parallel.multihost', 'kvarq_tpu_torch.graft_entry',
            'kvarq_tpu_torch.gui.simple', 'kvarq_tpu_torch.tools.device_bench',
            'kvarq_tpu_torch.tools.hitdiff', 'kvarq_tpu_torch.tools.gz_bench'
            } <= set(info['modules'])

    ref, rhits, rbatch = (str(tmp_path / n) for n in
                          ('ref.json', 'ref.fastq', 'refbatch.json'))
    # kvarq_tpu reads with one thread: its threaded reader can lose the
    # wake-up at the end of input
    jcli.main(['-q', '-t', TESTSUITES, 'scan', '-t', '1', '-f', '-l', 'MTBC',
               '--backend', 'numpy', '-H', '-x', rhits, FASTQ2, ref])
    jcli.main(['-q', '-t', TESTSUITES, 'batch', '-t', '1', '-f', '-l', 'MTBC',
               FASTQ2, rbatch])
    got, want = _json(out), _json(ref)
    for key in ('coverages', 'analyses', 'stats', 'hits', 'hitseqs'):
        assert got[key] == want[key], key
    with open(hits, 'rb') as a, open(rhits, 'rb') as b:
        assert a.read() == b.read()
    got, want = _json(batch), _json(rbatch)
    for key in ('coverages', 'analyses', 'stats'):
        assert got[key] == want[key], key
    assert got['info']['version'] == want['info']['version']


# --- testsuites through both packages -----------------------------------------

BOTH = r'''
import json, os, sys
order, ts, result = sys.argv[1:4]
if order == 'cached_util':
    # a sibling helper cached under kvarq_tpu, as a plugin's own import
    # leaves it: the port must not reuse it
    import kvarq
    sys.path.insert(0, os.path.join(ts, 'MTBC'))
    import _util
    sys.path.pop(0)
    cached = sys.modules['_util']
    assert type(_util.ancestor).__module__ == 'kvarq_tpu.genes'


def load(pkg):
    mod = __import__(pkg + '.testsuites', fromlist=['x'])
    genes = __import__(pkg + '.genes', fromlist=['x'])
    analyse = __import__(pkg + '.analyse', fromlist=['x'])
    suites = mod.load_testsuites(mod.discover_testsuites([ts]), ['MTBC'])
    assert len(suites) == 3
    genomes = 0
    for suite in suites.values():
        assert isinstance(suite, genes.Testsuite)
        for test in suite.tests:
            assert isinstance(test, genes.Test)
            assert isinstance(test.template, genes.Template)
            genome = getattr(test.template, 'genome', None)
            if genome is not None:
                assert isinstance(genome, genes.Genome), type(genome)
                genomes += 1
    assert genomes > 0
    with open(result) as fd:
        data = json.load(fd)
    an = analyse.Analyser()
    an.decode(suites, data)
    an.update_testsuites()
    return an.results


first, second = (('kvarq_tpu', 'kvarq_tpu_torch') if order == 'jax_first'
                 else ('kvarq_tpu_torch', 'kvarq_tpu'))
results = {first: load(first)}
if order == 'cached_util':
    # the port put back what it evicted
    assert sys.modules['_util'] is cached
results[second] = load(second)
print(json.dumps(results))
'''


@pytest.fixture(scope='module')
def mtbc_result(tmp_path_factory):
    ''' kvarq_tpu's result json of the 1k-read MTBC fixture '''
    path = str(tmp_path_factory.mktemp('both') / 'ref.json')
    jcli.main(['-q', '-t', TESTSUITES, 'scan', '-t', '1', '-f', '-l', 'MTBC',
               '--backend', 'numpy', FASTQ2, path])
    return path


@pytest.mark.parametrize('order', ['jax_first', 'port_first', 'cached_util'])
def test_testsuites_load_through_both_packages(order, mtbc_result):
    ''' one process loads the MTBC suites through kvarq_tpu and through
        the port, in either order (and with a sibling helper cached under
        kvarq_tpu): each package's objects are of its own classes, and
        both give the analyses of the scan '''
    proc = subprocess.run(
        [sys.executable, '-c', BOTH, order, TESTSUITES, mtbc_result],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    results = json.loads(proc.stdout.strip().splitlines()[-1])
    assert results['kvarq_tpu'] == results['kvarq_tpu_torch'] \
        == _json(mtbc_result)['analyses']


def test_loader_restores_the_kvarq_names():
    ''' after a plugin load through the port, ``kvarq`` and its submodules
        are what they were before (here: kvarq_tpu's alias package) '''
    import kvarq
    import kvarq.genes
    from kvarq_tpu_torch import testsuites as tts_
    before = {k: sys.modules.get(k) for k in ('kvarq', 'kvarq.genes',
                                               'kvarq.log')}
    suites = tts_.load_testsuites(tts_.discover_testsuites([TESTSUITES]),
                                  ['MTBC/spoligo'])
    assert suites
    assert {k: sys.modules.get(k) for k in before} == before
    assert kvarq.genes.__name__ == 'kvarq_tpu.genes'


# --- the port's copies of kvarq_tpu's host helpers ---------------------------

def test_generate_fastq_matches_bench(tmp_path):
    ''' the corpus generator writes the root bench.py's bytes '''
    sys.path.insert(0, ROOT)
    try:
        import bench
    finally:
        sys.path.remove(ROOT)
    rng = np.random.RandomState(3)
    windows = [''.join(rng.choice(list('ACGT'), rng.randint(40, 150)))
               for _ in range(12)]
    a, b = str(tmp_path / 'a.fastq'), str(tmp_path / 'b.fastq')
    bench.generate_fastq(a, windows, 2000, 101)
    tbench.generate_fastq(b, windows, 2000, 101)
    with open(a, 'rb') as fa, open(b, 'rb') as fb:
        data = fa.read()
        assert data == fb.read() and len(data) > 2000 * 101
    # the plant argument equals the module knob
    saved = bench.PLANT_FRAC
    bench.PLANT_FRAC = 0.5
    try:
        bench.generate_fastq(a, windows, 500, 71, seed=4)
    finally:
        bench.PLANT_FRAC = saved
    tbench.generate_fastq(b, windows, 500, 71, seed=4, plant=0.5)
    with open(a, 'rb') as fa, open(b, 'rb') as fb:
        assert fa.read() == fb.read()


@pytest.mark.parametrize('seed', [0, 1])
@pytest.mark.parametrize('maxerrors,minoverlap', [(0, 25), (3, 8)])
def test_match_numpy_matches_kvarq_tpu(seed, maxerrors, minoverlap):
    rng = np.random.RandomState(seed)
    seqs, codes, rl, raw = _random_case(rng, nseq=6, B=40, Lpad=64)
    batch = RecordBatch(codes, rl, np.zeros(len(rl), np.int64), raw)
    want = jmatch_numpy.NumpyMatcher(seqs, maxerrors, minoverlap) \
        .match_batch(batch)
    got = tmatch_numpy.NumpyMatcher(seqs, maxerrors, minoverlap) \
        .match_batch(batch)
    assert len(want) > 0
    np.testing.assert_array_equal(np.unique(got, axis=0),
                                  np.unique(want, axis=0))


@pytest.mark.parametrize('nch', [4, 5])
@pytest.mark.parametrize('Lpad,minoverlap', [(64, 25), (36, None)])
def test_bank_layout_matches_kvarq_tpu(nch, Lpad, minoverlap):
    ''' _Bank, bank_channels, pack_qmeta, pack_tseg (default and explicit
        Qp) and fold_into_coverage equal kvarq_tpu's '''
    seqs, _, _, _ = case(nch + Lpad, nch, Lpad=Lpad, nseq=9)
    jb = jts.build_bank(seqs, Lpad, minoverlap)
    tb = tts.build_bank(seqs, Lpad, minoverlap)
    for key in ('codes', 'tid', 'd_of', 'seql_of', 'tstart'):
        np.testing.assert_array_equal(getattr(tb, key), getattr(jb, key))
    assert (tb.G, tb.Q) == (jb.G, jb.Q)
    assert tps.bank_channels(tb.codes) == jps.bank_channels(jb.codes) == nch
    T = len(seqs)
    for kw in ({}, {'TQ': 128}, {'Qp': tb.Q + 77}):
        np.testing.assert_array_equal(tps.pack_qmeta(tb, **kw),
                                      jps.pack_qmeta(jb, **kw))
        np.testing.assert_array_equal(tps.pack_tseg(tb, T, **kw),
                                      jps.pack_tseg(jb, T, **kw))


def test_fold_into_coverage_matches_kvarq_tpu():
    from kvarq_tpu import analyse as janalyse
    from kvarq_tpu.genes import Sequence as JSequence
    from kvarq_tpu_torch import analyse as tanalyse
    from kvarq_tpu_torch.genes import Sequence as TSequence
    rng = np.random.RandomState(5)
    bases = ''.join(rng.choice(list('ACGTN'), 80))
    plus, minus = rng.randint(0, 4, (2, 5, 80))
    jc = janalyse.Coverage(JSequence(bases, 5, 5))
    tc = tanalyse.Coverage(TSequence(bases, 5, 5))
    jts.fold_into_coverage(jc, plus, minus)
    tencode.fold_into_coverage(tc, plus, minus)
    assert tc.serialize() == jc.serialize()


@pytest.mark.parametrize('n_bank', [1, 2, 3])
def test_numpy_shard_bank_matches_kvarq_tpu(n_bank):
    seqs, _, _, _ = case(20 + n_bank, 5, Lpad=64, nseq=7)
    want = jparallel.ShardBank(seqs, 64, n_bank, 25)
    got = tparallel.ShardBank(seqs, 64, n_bank, 25)
    assert got.ranges == want.ranges and got.G == want.G
    for key in ('codes', 'tid', 'd_of', 'seql_of'):
        np.testing.assert_array_equal(getattr(got, key), getattr(want, key))
    assert got.channels() == want.channels()
    for a, b in zip(got.sub, want.sub):
        np.testing.assert_array_equal(a.codes, b.codes)


def test_sample_max_readlen_matches_kvarq_tpu(tmp_path):
    from kvarq_tpu.parallel.multihost import sample_max_readlen as jsample
    from kvarq_tpu_torch.parallel.multihost import sample_max_readlen
    files = [FASTQ1, FASTQ2, str(tmp_path / 'missing.fastq')]
    assert sample_max_readlen(files) == jsample(files) > 0
    assert sample_max_readlen(files, 3) == jsample(files, 3)


# --- the kernel's operands ----------------------------------------------------

def kernel_operands(codes, state):
    ''' the int8 operands of csrc/cand_screen.cu, built from what it is
        given (read codes, ``state.bank``) as the kernel builds them:
        A ``[B, depth]`` and the K-major bank operand ``[Qp, depth]``.
        Depth segment 0 is ``Lpad`` words, word ``j`` holding the A, C, G,
        T indicator bytes of position ``j``; with 5 channels segment 1 holds
        one N indicator byte per position.  Each segment is padded with
        zeros to whole MMA steps of 32 bytes. '''
    Lpad, nch, Qp = codes.shape[1], state.nch, state.Qp
    win = state.bank.long().unfold(0, Lpad, 1)[:Qp]        # [Qp, Lpad]

    def operand(x):
        seg0 = (x[..., None] == torch.arange(4)).to(torch.int8)
        segs = [seg0.reshape(len(x), 4 * Lpad)]
        if nch == 5:
            segs.append((x == 4).to(torch.int8))
        out = []
        for s in segs:
            pad = -s.shape[1] % 32
            out.append(torch.nn.functional.pad(s, (0, pad)))
        return torch.cat(out, dim=1)

    return operand(codes.long()), operand(win)


@pytest.mark.parametrize('nch', [4, 5])
@pytest.mark.parametrize('Lpad', [36, 64, 128])
def test_kernel_operands_match_K(nch, Lpad):
    ''' the kernel's bank bytes (``state.bank``, padded and with every
        code >= nch made a sentinel) give the im2col'd one-hot bank: the
        int8 product of the kernel's operands equals the match counts of
        ``state.K`` '''
    seqs, codes, rl, bank = case(3 * Lpad + nch, nch, B=50, Lpad=Lpad,
                                 nseq=8)
    state = tps.device_arrays(bank, len(seqs), 'cpu')
    c = torch.from_numpy(codes)
    a, b = kernel_operands(c, state)
    assert a.shape[1] == b.shape[1] and a.shape[1] % 32 == 0
    got = a.int() @ b.int().T
    want = tps.match_counts(c, state.K, nch)
    assert torch.equal(got, want.int())
    assert int(want.max()) > 20
