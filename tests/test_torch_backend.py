'''
The port engine's ``backend`` key and its compressed input, on the CPU.
Every comparison is exact equality (hits, hit sequences, base counts and
stats are integer counts and strings):

- ``backend='numpy'``: ``findseqs`` hits and ``countseqs`` base counts
  equal kvarq_tpu's numpy paths on the engine fixture, the paired gz
  fixtures and the golden 5k MTBC extract, and the port's own device
  path on the CPU (the inputs are AGCTN-only: the numpy matcher compares
  raw bytes, the device paths never match junk bytes); ``scan --backend
  numpy`` writes kvarq_tpu's json;
- ``backend='auto'``: ``_small_scan_eligible`` (gz counted 8x, FIFOs
  refused, another backend, a mesh, CUDA initialised), and the path an
  auto scan takes with no card;
- the default never leaves the card: with none, a scan fails;
- the scan start publishes the new scan's state before ``_running``;
- gz and BGZF (``kvarq_tpu_torch.tools.gz_bench``'s writers) read back
  through the port's reader as the plain file does, and scan to its
  results.
'''

import gzip
import json
import os
import shutil
import threading
import time

import numpy as np
import pytest
import torch

from kvarq_tpu import cli as jcli
from kvarq_tpu import engine as jengine
from kvarq_tpu.analyse import Analyser as JAnalyser
from kvarq_tpu.log import set_warning
from kvarq_tpu.testsuites import discover_testsuites, load_testsuites
from kvarq_tpu_torch import bench as tbench
from kvarq_tpu_torch import cli
from kvarq_tpu_torch import engine as tengine
from kvarq_tpu_torch.engine import reader as treader
from kvarq_tpu_torch.tools import gz_bench, hitdiff

from _torch_log import restore_log_levels  # noqa: F401
from test_engine import FNAME, FNAME_1, FNAME_2, SEQS7

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
    ''' every test starts from the port engine's built-in defaults on the
        CPU, and leaves the device path as the backend '''
    tengine.config(maxerrors=0, minoverlap=20, minreadlength=10,
                   nthreads=1, Amin='!', Azero='!', device='cpu',
                   backend='device', mesh='', sieve='auto', batchsize=16384)
    yield
    tengine.config(backend='device', mesh='')


def _mtbc_seqs():
    set_warning()
    suites = load_testsuites(discover_testsuites([TESTSUITES]), ['MTBC'])
    covs = JAnalyser().load_coverages(suites, spacing=25)
    return [c.plus_seq.bases for c in covs.values()] \
        + [c.minus_seq.bases for c in covs.values()]


# (fastq or files, templates, engine parameters)
CASES = {
    'engine e0': (FNAME, SEQS7, dict(maxerrors=0, minoverlap=1000,
                                     minreadlength=3, Amin='!')),
    'engine e1 o3': (FNAME, SEQS7, dict(maxerrors=1, minoverlap=3,
                                        minreadlength=3, Amin='!')),
    'paired gz': ((FNAME_1 + '.gz', FNAME_2 + '.gz'), SEQS7,
                  dict(maxerrors=1, minoverlap=5, minreadlength=3,
                       Amin='!')),
    'golden 5k': (FASTQ1, None, dict(maxerrors=2, minoverlap=25,
                                     minreadlength=25, Amin=chr(33 + 13))),
}


def _case(name):
    fastq, seqs, params = CASES[name]
    if seqs is None:
        if not os.path.exists(os.path.join(TESTSUITES, 'MTBC',
                                           'MTB_ancestor_reference.bases')):
            pytest.skip('run tools/reconstruct_genome.py first')
        seqs = _mtbc_seqs()
    return fastq, list(seqs), params


def _jax_numpy_countseqs(monkeypatch, fastq, seqs):
    ''' kvarq_tpu's numpy countseqs: its small-input path, which folds the
        numpy hit list (``_basecounts_from_hits``) '''
    monkeypatch.setattr(jengine, 'SMALL_SCAN_BYTES', 1 << 40)
    monkeypatch.setattr(jengine, '_jax_device_ready', lambda: False)
    jengine.config(backend='auto', nthreads=1)
    return jengine.countseqs(fastq, seqs)


@pytest.mark.parametrize('name', list(CASES))
def test_numpy_backend_matches_kvarq_tpu(name, monkeypatch):
    ''' findseqs and countseqs with backend numpy equal kvarq_tpu's numpy
        paths, sieve on (as the engines default) '''
    fastq, seqs, params = _case(name)
    jengine.config(backend='numpy', nthreads=1, **params)
    want = jengine.findseqs(fastq, seqs)
    tengine.config(backend='numpy', device='cuda', **params)
    got = tengine.findseqs(fastq, seqs)
    assert len(want['hits']) > 0
    assert got['hits'] == want['hits']
    assert got['hitseqs'] == want['hitseqs']
    assert got['stats'] == want['stats']

    want = _jax_numpy_countseqs(monkeypatch, fastq, seqs)
    got = tengine.countseqs(fastq, seqs)
    assert got['stats'] == want['stats']
    for a, b in zip(got['basecounts'], want['basecounts']):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('sieve', ['auto', 'off'])
@pytest.mark.parametrize('name', list(CASES))
def test_numpy_backend_matches_cpu_device(name, sieve):
    ''' the port's numpy path equals its device path on the CPU (AGCTN-only
        inputs), with the sieve on and off '''
    fastq, seqs, params = _case(name)
    out = {}
    for backend in ('numpy', 'device'):
        tengine.config(backend=backend, sieve=sieve, **params)
        out[backend] = (tengine.findseqs(fastq, seqs),
                        tengine.countseqs(fastq, seqs))
    (fn, cn), (fd, cd) = out['numpy'], out['device']
    assert len(fn['hits']) > 0
    assert fn == fd
    assert cn['stats'] == cd['stats'] == fn['stats']
    for a, b in zip(cn['basecounts'], cd['basecounts']):
        np.testing.assert_array_equal(a, b)


@needs_genome
@pytest.mark.parametrize('fastq,extra', [
    ('L3_N1014_hits_5k.fastq', ['--variant', 'Illumina 1.8+', '-H']),
    ('N0116_1_hits_1k.fastq', [])])
def test_cli_numpy_matches_kvarq_tpu(fastq, extra, tmp_path, monkeypatch):
    ''' ``scan --backend numpy`` writes kvarq_tpu's json, with no card '''
    fastq = os.path.join(HERE, 'fastqs', fastq)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    out = {}
    # kvarq_tpu reads with one thread: its threaded reader can lose the
    # wake-up at the end of input
    for name, main, threads in (('ref', jcli.main, ['-t', '1']),
                                ('got', cli.main, [])):
        out[name] = str(tmp_path / (name + '.json'))
        main(['-q', '-t', TESTSUITES, 'scan', *threads, '-f', '-l', 'MTBC',
              '--backend', 'numpy', *extra, fastq, out[name]])
    with open(out['ref']) as a, open(out['got']) as b:
        ref, got = json.load(a), json.load(b)
    keys = ('coverages', 'analyses', 'stats') + (
        ('hits', 'hitseqs') if '-H' in extra else ())
    for key in keys:
        assert got[key] == ref[key], key


# --- auto: the small-scan shortcut -------------------------------------------

@pytest.fixture
def auto(monkeypatch):
    ''' backend auto with the shortcut at 4 MB, CUDA cold '''
    monkeypatch.setattr(tengine, 'SMALL_SCAN_BYTES', 4000000)
    monkeypatch.setattr(torch.cuda, 'is_initialized', lambda: False)
    tengine.config(backend='auto')
    return monkeypatch


def test_small_scan_eligible(auto, tmp_path):
    ''' small regular files are eligible; gz counts 8x its size '''
    assert tengine._small_scan_eligible([FNAME])
    assert tengine._small_scan_eligible([FNAME_1 + '.gz', FNAME_2 + '.gz'])
    gz = os.path.getsize(FNAME + '.gz')
    auto.setattr(tengine, 'SMALL_SCAN_BYTES', 4 * gz)
    assert os.path.getsize(FNAME) < 4 * gz <= 8 * gz
    assert tengine._small_scan_eligible([FNAME])
    assert not tengine._small_scan_eligible([FNAME + '.gz'])
    # a gz file under another suffix is seen by its magic bytes
    bgz = str(tmp_path / 'x.fastq.bgz')
    shutil.copy(FNAME + '.gz', bgz)
    assert not tengine._small_scan_eligible([bgz])
    auto.setattr(tengine, 'SMALL_SCAN_BYTES', 0)
    assert not tengine._small_scan_eligible([FNAME])


def test_small_scan_refuses_a_fifo(auto, tmp_path):
    ''' a FIFO is not sniffed (that would eat the reader's bytes) '''
    fifo = str(tmp_path / 'pipe.fastq')
    os.mkfifo(fifo)
    assert not tengine._small_scan_eligible([FNAME, fifo])
    assert not tengine._small_scan_eligible([str(tmp_path / 'missing')])


@pytest.mark.parametrize('config', [dict(backend='device'),
                                    dict(backend='numpy'),
                                    dict(mesh='1x1'), dict(mesh='auto')])
def test_small_scan_needs_auto_and_no_mesh(auto, config):
    tengine.config(**config)
    assert not tengine._small_scan_eligible([FNAME])


def test_small_scan_not_once_cuda_is_initialised(auto):
    auto.setattr(torch.cuda, 'is_initialized', lambda: True)
    assert not tengine._small_scan_eligible([FNAME])


@pytest.mark.parametrize('scan', ['findseqs', 'countseqs'])
def test_auto_takes_numpy_only_for_small_input(auto, scan):
    ''' with no card, auto on a small input scans via numpy (equal to the
        numpy backend); on an input over the limit it goes to the card,
        and fails there: nothing falls back to numpy or the CPU '''
    auto.setattr(torch.cuda, 'is_available', lambda: False)
    fastq, seqs, params = _case('engine e1 o3')
    tengine.config(backend='numpy', **params)
    want = getattr(tengine, scan)(fastq, seqs)
    tengine.config(backend='auto', device='cuda')
    got = getattr(tengine, scan)(fastq, seqs)
    assert repr(got) == repr(want)
    auto.setattr(tengine, 'SMALL_SCAN_BYTES', os.path.getsize(fastq))
    with pytest.raises(RuntimeError, match='is_available'):
        getattr(tengine, scan)(fastq, seqs)
    assert not tengine._running


def test_numpy_ignores_a_mesh():
    ''' backend numpy scans on the host whatever mesh is configured '''
    fastq, seqs, params = _case('engine e1 o3')
    tengine.config(backend='numpy', **params)
    want = tengine.findseqs(fastq, seqs)
    tengine.config(mesh='4x2', device='cuda')
    assert tengine.findseqs(fastq, seqs) == want


@pytest.mark.parametrize('backend', ['xla', 'pallas', 'cuda'])
def test_other_backends_are_refused(backend):
    ''' kvarq_tpu's xla and pallas name the port's counterparts; the
        setting is left as it was '''
    with pytest.raises(TypeError, match="counterpart|device 'c" if backend
                       != 'cuda' else 'device, numpy, auto$'):
        tengine.config(backend=backend)
    assert tengine._extra_config['backend'] == 'device'


# --- the default stays on the card -------------------------------------------

@pytest.mark.parametrize('scan', ['findseqs', 'countseqs'])
def test_default_scan_without_a_card_fails(scan, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    tengine.config(device='cuda')
    with pytest.raises(RuntimeError, match='is_available'):
        getattr(tengine, scan)(FNAME, SEQS7)


@needs_genome
@pytest.mark.parametrize('env', [None, 'device', 'xla'])
def test_default_cli_scan_without_a_card_fails(env, tmp_path, monkeypatch,
                                               capsys):
    ''' ``kvarq scan`` with no --backend (and $KVARQ_BACKEND unset or not
        numpy/auto) runs on the card: with none it exits before scanning,
        writing nothing '''
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    if env is None:
        monkeypatch.delenv('KVARQ_BACKEND', raising=False)
    else:
        monkeypatch.setenv('KVARQ_BACKEND', env)
    out = tmp_path / 'out.json'
    with pytest.raises(SystemExit) as e:
        cli.main(['-q', '-t', TESTSUITES, 'scan', '-f', '-l', 'MTBC',
                  FASTQ2, str(out)])
    assert e.value.code != 0
    assert not out.exists()
    err = capsys.readouterr().err
    assert ('is_available' in err) if env != 'xla' else \
        ('counterpart is --backend cpu' in err)


# --- the scan start ----------------------------------------------------------

def test_poller_never_sees_the_previous_scan(monkeypatch, tmp_path):
    ''' a poller that watches ``_running`` and ``stats()`` while a second
        scan starts never sees the first scan's records or counters: the
        second scan's reader stats are held back until the poller has
        polled, and meanwhile the engine does not report it running '''
    first = str(tmp_path / 'first.fastq')
    second = str(tmp_path / 'second.fastq')
    hitdiff.random_corpus(first, list(SEQS7[-2:]), 400, seed=1)
    hitdiff.random_corpus(second, list(SEQS7[-2:]), 50, seed=2)
    tengine.config(backend='numpy', maxerrors=1, minoverlap=10,
                   minreadlength=10)
    ret = tengine.countseqs(first, list(SEQS7))
    assert ret['stats']['records_parsed'] == 400
    assert ret['stats']['progress'] == 1.0

    entered, release = threading.Event(), threading.Event()

    class HeldStats(treader.ReaderStats):
        def __init__(self):
            entered.set()
            assert release.wait(10)
            super().__init__()

    monkeypatch.setattr(treader, 'ReaderStats', HeldStats)
    seen = []

    def poll():
        running = tengine._running
        st = tengine.stats()
        seen.append(running)
        if running:
            assert st['records_parsed'] <= 50, st
            assert len(st['nseqhits']) == 2, st

    result = {}
    worker = threading.Thread(target=lambda: result.update(
        tengine.countseqs(second, list(SEQS7[-2:]))), daemon=True)
    worker.start()
    try:
        assert entered.wait(10)
        for _ in range(200):
            poll()
            time.sleep(0.0005)
    finally:
        release.set()
    # a scan that hangs fails this test, and no other
    deadline = time.time() + 60
    while worker.is_alive() and time.time() < deadline:
        poll()
    worker.join(1)
    assert not worker.is_alive(), 'the second scan did not end in 60 s'
    assert result['stats']['records_parsed'] == 50
    assert not any(seen[:200])


# --- gz and BGZF -------------------------------------------------------------

@pytest.fixture(scope='module')
def compressed(tmp_path_factory):
    ''' a 3,000-read corpus of hitdiff's with its gz and BGZF copies (BGZF
        blocks of 7,000 bytes, so that many blocks and records straddle
        them) '''
    d = tmp_path_factory.mktemp('gz')
    rng = np.random.RandomState(11)
    seqs = hitdiff.random_templates(rng, 8)
    plain = str(d / 'c_1.fastq')
    hitdiff.random_corpus(plain, seqs, 3000, seed=12, with_n=True)
    gz_bench.write_gz(str(d / 'c_1.fastq.gz'), plain)
    os.makedirs(d / 'bgzf')
    gz_bench.write_bgzf(str(d / 'bgzf' / 'c_1.fastq.gz'), plain, block=7000)
    return {'plain': plain, 'gz': str(d / 'c_1.fastq.gz'),
            'bgzf': str(d / 'bgzf' / 'c_1.fastq.gz')}, seqs


@pytest.mark.parametrize('variant', ['gz', 'bgzf'])
def test_writers_round_trip_through_the_reader(compressed, variant):
    ''' the reader gives the plain file's batches (codes, read lengths,
        file positions, raw bytes) and stats over the gz and BGZF copies,
        which inflate to the plain bytes '''
    files, _ = compressed
    with open(files['plain'], 'rb') as f, gzip.open(files[variant]) as g:
        assert f.read() == g.read()
    out = {}
    for name in ('plain', variant):
        stats = treader.ReaderStats()
        out[name] = (list(treader.batches([files[name]], ord('#') + 1, 10,
                                          stats, batchsize=512, nthreads=2)),
                     stats)
    (pb, ps), (vb, vs) = out['plain'], out[variant]
    assert len(pb) == len(vb) > 4
    for a, b in zip(pb, vb):
        for key in ('codes', 'rl', 'filepos', 'raw'):
            np.testing.assert_array_equal(getattr(a, key), getattr(b, key))
    assert vs.records_parsed == ps.records_parsed == 3000
    assert vs.parsed == ps.parsed
    assert list(vs.rls) == list(ps.rls)
    assert gz_bench.drain(files[variant], 2)[:3] == \
        gz_bench.drain(files['plain'], 2)[:3]


def test_threaded_reader_always_reaches_its_end():
    ''' the threaded reader over a small file, many times, with more
        workers than cores: every run ends, with every record, in a
        bounded time.  The end of input was once signalled without the
        consumer's lock, and a run could then wait forever (a lost
        wake-up: one run in thousands on an 8-core host). '''
    runs, nthreads = 800, (os.cpu_count() or 1) + 2
    counts = []
    done = threading.Event()

    def scan():
        for _ in range(runs):
            batches = treader.batches([FNAME], ord('!'), 5,
                                      treader.ReaderStats(),
                                      nthreads=nthreads)
            counts.append(sum(len(b) for b in batches))
        done.set()
    threading.Thread(target=scan, daemon=True).start()
    assert done.wait(120), 'the reader hung after %d runs' % len(counts)
    assert len(counts) == runs and len(set(counts)) == 1 and counts[0] > 0


@pytest.mark.parametrize('sieve', ['auto', 'off'])
def test_compressed_scan_equals_plain(compressed, sieve):
    ''' countseqs and findseqs on the CPU give equal results over the
        plain, gz and BGZF inputs (apart from ``total``, an estimate) '''
    files, seqs = compressed
    seqs = seqs + [hitdiff._revcomp(s) for s in seqs]
    tengine.config(maxerrors=2, minoverlap=20, minreadlength=10,
                   Amin=chr(ord('#') + 1), sieve=sieve, nthreads=2)
    out = {}
    for name, path in files.items():
        c, f = tengine.countseqs(path, seqs), tengine.findseqs(path, seqs)
        for ret in (c, f):
            ret['stats'].pop('total')
        out[name] = c, f
    (cp, fp) = out['plain']
    assert len(fp['hits']) > 100
    for name in ('gz', 'bgzf'):
        c, f = out[name]
        assert f == fp, name
        assert c['stats'] == cp['stats'], name
        for a, b in zip(c['basecounts'], cp['basecounts']):
            np.testing.assert_array_equal(a, b)


def test_paired_gz_matches_kvarq_tpu():
    ''' the port's device path on the CPU over the paired gz fixtures
        equals kvarq_tpu's numpy hit path and its coverage path '''
    fastq, seqs, params = _case('paired gz')
    jengine.config(backend='numpy', nthreads=1, **params)
    want = jengine.findseqs(fastq, seqs)
    jengine.config(backend='xla')
    wantc = jengine.countseqs(fastq, seqs)
    tengine.config(**params)
    got = tengine.findseqs(fastq, seqs)
    assert got == want and len(got['hits']) > 0
    gotc = tengine.countseqs(fastq, seqs)
    assert gotc['stats'] == wantc['stats']
    for a, b in zip(gotc['basecounts'], wantc['basecounts']):
        np.testing.assert_array_equal(a, b)


def test_bench_path_is_in_the_checkout():
    ''' the corpus helpers copied from the root bench.py: its names, its
        size, a file inside the checkout's build tree '''
    assert (tbench.N_READS, tbench.READLEN) == (2000000, 101) or \
        'KVARQ_BENCH_READS' in os.environ
    path = tbench.bench_path('mtbc')
    assert path.startswith(os.path.join(ROOT, 'build', 'kvarq_tpu_torch'))
    assert os.path.basename(path) == 'kvarq_bench_mtbc_%dx%d.fastq' % (
        tbench.N_READS, tbench.READLEN)
