'''
The hit-list scan of kvarq_tpu_torch against kvarq_tpu on the CPU: the
exact extraction against ``XlaMatcher``, the screening matcher (plain
screen) against ``PallasMatcher`` in interpret mode, ``findseqs`` against
kvarq_tpu's numpy and xla ``findseqs`` tuple for tuple and in order (on
both of the port's matchers), against tools/ref_bench.c's hit stream and
against the port's own ``countseqs``, and ``Analyser.scan`` with hits on
the MTBC fixtures.  Every comparison is exact equality.
'''

import os
import random
import sys

import numpy as np
import pytest
import torch

from kvarq_tpu import analyse as janalyse
from kvarq_tpu import engine as jengine
from kvarq_tpu.engine import encode
from kvarq_tpu.engine.match_pallas import PallasMatcher as JaxPallasMatcher
from kvarq_tpu.engine.match_xla import XlaMatcher as JaxXlaMatcher
from kvarq_tpu.engine.reader import RecordBatch
from kvarq_tpu.fastq import Fastq
from kvarq_tpu.log import set_warning
from kvarq_tpu.testsuites import discover_testsuites, load_testsuites
from kvarq_tpu_torch import analyse
from kvarq_tpu_torch import engine as tengine
from kvarq_tpu_torch import testsuites as ttestsuites
from kvarq_tpu_torch.fastq import Fastq as TFastq
from kvarq_tpu_torch.fastq import \
    FastqFileFormatException as TFastqFileFormatException
from kvarq_tpu_torch.engine import match_pallas, match_xla
from kvarq_tpu_torch.engine import pallas_scan as tps

from _torch_cases import case
from _torch_log import restore_log_levels  # noqa: F401
from test_engine import FNAME, FNAME_1, FNAME_2, SEQS7, FastqGenerator

HERE = os.path.abspath(os.path.dirname(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, 'tools'))
import bench  # noqa: E402
import hitdiff  # noqa: E402

TESTSUITES = os.path.join(ROOT, 'testsuites')
FASTQ1 = os.path.join(HERE, 'fastqs', 'L3_N1014_hits_5k.fastq')
FASTQ2 = os.path.join(HERE, 'fastqs', 'N0116_1_hits_1k.fastq')


@pytest.fixture(autouse=True)
def reset_torch_engine_config():
    ''' every test starts from the port engine's built-in defaults '''
    tengine.config(maxerrors=0, minoverlap=20, minreadlength=10,
                   nthreads=1, Amin='!', Azero='!', device='cpu',
                   sieve=os.environ.get('KVARQ_SIEVE', 'auto'),
                   batchsize=int(os.environ.get('KVARQ_BATCHSIZE', '16384')))
    yield


@pytest.fixture(params=['xla', 'pallas'])
def matcher(request, monkeypatch):
    ''' the port's findseqs through the exact matcher (the engine's choice
        on the CPU) or through the screening matcher with the plain screen
        (its choice on the card) '''
    if request.param == 'pallas':
        monkeypatch.setattr(
            tengine, '_make_matcher',
            lambda seqs: match_pallas.PallasMatcher(
                seqs, tengine._config['maxerrors'],
                tengine._config['minoverlap'], 'cpu'))
    return request.param


def _sorted(tri):
    tri = np.asarray(tri, dtype=np.int64).reshape(-1, 3)
    return tri[np.lexsort(tri.T[::-1])]


def _batch(codes, rl):
    return RecordBatch(codes, rl, np.zeros(len(codes), np.int64),
                       np.zeros_like(codes))


def _planted_case(seed, nch, B, Lpad, minoverlap):
    ''' a case of _torch_cases with every third read also carrying a whole
        template as the bank has it (N included), so that exact hits
        occur at any maxerrors '''
    seqs, codes, rl, bank = case(seed, nch, B=B, Lpad=Lpad,
                                 minoverlap=minoverlap)
    rng = np.random.RandomState(seed)
    for b in range(1, B, 3):
        t = encode.encode_template(seqs[rng.randint(len(seqs))])
        off = rng.randint(0, Lpad - len(t) + 1)
        codes[b, off:off + len(t)] = t
        rl[b] = max(rl[b], off + len(t))
        codes[b, rl[b]:] = encode.CODE_READ_JUNK
    return seqs, codes, rl, bank


# --- the matchers ------------------------------------------------------------

@pytest.mark.parametrize('Lpad', [64, 192])
@pytest.mark.parametrize('maxerrors,minoverlap', [(0, 25), (2, 25), (3, 8)])
@pytest.mark.parametrize('nch', [4, 5])
def test_extract_matches_xla_matcher(nch, maxerrors, minoverlap, Lpad):
    ''' the exact extraction gives kvarq_tpu's XlaMatcher triplets, also
        when it runs in passes of a few reads '''
    seqs, codes, rl, bank = _planted_case(60 + Lpad + maxerrors, nch, 24,
                                          Lpad, minoverlap)
    want = JaxXlaMatcher(seqs, maxerrors, minoverlap).match_batch(
        _batch(codes, rl))
    assert len(want) > 0
    got = match_xla.XlaMatcher(seqs, maxerrors, minoverlap, 'cpu') \
        .match_batch(_batch(codes, rl))
    np.testing.assert_array_equal(_sorted(got), _sorted(want))

    state = tps.device_arrays(bank, len(seqs), 'cpu')
    passes = match_xla.extract(torch.from_numpy(codes), torch.from_numpy(rl),
                               state, maxerrors, minoverlap, rows=5)
    np.testing.assert_array_equal(_sorted(passes), _sorted(want))


@pytest.mark.parametrize('nch', [4, 5])
def test_screening_matcher_matches_pallas(nch, monkeypatch):
    ''' the screening matcher (plain screen on the CPU, compaction, exact
        extraction, row ids mapped back) gives the triplets of kvarq_tpu's
        PallasMatcher in interpret mode, with the extraction in one pass
        and in passes of 5 reads '''
    seqs, codes, rl, _ = case(11, nch, B=32, Lpad=64, nseq=5, minoverlap=20)
    want = JaxPallasMatcher(seqs, 2, 20, sub=32, TB=8, TQ=128).match_batch(
        _batch(codes, rl))
    assert len(want) > 0

    got = match_pallas.PallasMatcher(seqs, 2, 20, 'cpu')
    np.testing.assert_array_equal(
        _sorted(got.match_batch(_batch(codes, rl))), _sorted(want))
    flags = tps.cand_counts(torch.from_numpy(codes), torch.from_numpy(rl),
                            got.xla.context(64)[0], 2, 20, nch) > 0
    assert flags.any() and not flags.all()   # compaction drops rows

    monkeypatch.setattr(match_xla, 'score_rows', lambda device, Qp: 5)
    got = match_pallas.PallasMatcher(seqs, 2, 20, 'cpu')
    assert got.xla.context(64)[1] == 5
    np.testing.assert_array_equal(
        _sorted(got.match_batch(_batch(codes, rl))), _sorted(want))


def test_matchers_skip_padding_rows():
    ''' rl == 0 rows give no triplet, and an empty bank none at all '''
    seqs, codes, rl, _ = case(5, 4, B=16, Lpad=64, minoverlap=10)
    rl[::2] = 0
    for m in (match_xla.XlaMatcher(seqs, 1, 10, 'cpu'),
              match_pallas.PallasMatcher(seqs, 1, 10, 'cpu')):
        tri = m.match_batch(_batch(codes, rl))
        assert len(tri) > 0 and not (tri[:, 0] % 2 == 0).any()
    assert match_xla.XlaMatcher([], 1, 10, 'cpu').match_batch(
        _batch(codes, rl)).shape == (0, 3)


# --- findseqs against kvarq_tpu.engine.findseqs ------------------------------

# configurations with k = 12 seeds build a 5^12-entry sieve table (seconds
# and a GB each): those cases scan unsieved in both packages, and the
# shared sieve is held to the same hit stream by
# test_findseqs_sieve_equivalence and the MTBC cases
NO_SIEVE = dict(sieve='off')


def _same_as_kvarq_tpu(fname, seqs, **cfg):
    ''' the port's findseqs equals kvarq_tpu's with the numpy and the xla
        backend, tuple for tuple and in order; returns it.  kvarq_tpu reads
        with one thread: its threaded reader can lose the wake-up at the
        end of input '''
    tengine.config(**cfg)
    got = tengine.findseqs(fname, seqs)
    for backend in ('numpy', 'xla'):
        jengine.config(backend=backend, **dict(cfg, nthreads=1))
        want = jengine.findseqs(fname, seqs)
        assert got['hits'] == want['hits'], backend
        assert got['hitseqs'] == want['hitseqs'], backend
        assert got['stats'] == want['stats'], backend
    return got


@pytest.mark.parametrize('gz', [False, True])
def test_findseqs_seqs7(matcher, gz):
    ''' the handwritten fixture (tests/test_engine.py::test_findseqs) '''
    ret = _same_as_kvarq_tpu(FNAME + ('.gz' if gz else ''), SEQS7,
                             maxerrors=0, minoverlap=1000, minreadlength=3,
                             Amin='!')
    x = [0] * len(SEQS7)
    for hit in ret['hits']:
        x[hit.seq_nr] += 1
    assert x == [19, 1, 0, 1, 1, 1, 1]
    # the port's own Hit, with kvarq_tpu's fields
    assert tengine.Hit._fields == jengine.Hit._fields
    assert all(isinstance(h, tengine.Hit) for h in ret['hits'])


@pytest.mark.parametrize('gz', [False, True])
def test_findseqs_paired(matcher, gz):
    ''' a multi-file set scans as its concatenation '''
    sfx = '.gz' if gz else ''
    cfg = dict(maxerrors=0, minoverlap=1000, minreadlength=3, Amin='!')
    ret = _same_as_kvarq_tpu(FNAME + sfx, SEQS7, **cfg)
    ret_12 = _same_as_kvarq_tpu((FNAME_1 + sfx, FNAME_2 + sfx), SEQS7, **cfg)
    assert ret == ret_12


def test_findseqs_maxerrors(matcher):
    seqs = (
        "CAGCATGTGGAGCAACTTGTGGGAGCGCCGGGCAACGCCCTGTCTCTTAT",  # 1 error
        "CTGCATGTGGAGCAACTTGTGGGAGCGCCGGGCAACGCCCTGTCTCTTAT",  # 2 errors
        "CTCCATGTGGAGCAACTTGTGGGAGCGCCGGGCAACGCCCTGTCTCTTAT",  # 3 errors
    )
    for maxerrors in range(4):
        ret = _same_as_kvarq_tpu(FNAME, seqs, maxerrors=maxerrors,
                                 minreadlength=25, minoverlap=25, Amin='!',
                                 **NO_SIEVE)
        assert len(ret['hits']) == maxerrors


def test_findseqs_minoverlap(matcher):
    seqs = (
        "TCGATGCGATCTGTCAAGTCGGTGGCGGTA...",
        "TCGATGCGATCTG.CAAGTCGGTGGCGGTA...",
        "...NTGAACGTATCGCCTCGAGGGACTT",
        "...NTGAACGTATCG.CTCGAGGGACTT",
    )
    for e, mo, n in ((0, 30, 1), (0, 25, 2), (1, 25, 4)):
        ret = _same_as_kvarq_tpu(FNAME, seqs, maxerrors=e, minoverlap=mo,
                                 minreadlength=25, Amin='!', **NO_SIEVE)
        assert len(ret['hits']) == n


def test_findseqs_Amin(matcher):
    seqs = ("GGAG", "CCGAC")
    ret = _same_as_kvarq_tpu(FNAME, seqs, Amin='H', minreadlength=4,
                             maxerrors=0, minoverlap=25)
    assert len(ret['hits']) == 1
    assert ret['stats']['readlengths'][5] == 3
    assert ret['stats']['readlengths'][4] == 5
    ret = _same_as_kvarq_tpu(FNAME, seqs, Amin='G', minreadlength=4,
                             maxerrors=0, minoverlap=25)
    assert len(ret['hits']) == 2


def test_findseqs_generated(matcher, tmp_path):
    ''' n reads covering a random 51-mer give n hits; mutating every 25th
        base kills them all (tests/test_engine.py::test_hits_generated) '''
    random.seed(17)
    fname = str(tmp_path / 'generated.fastq')
    fq = FastqGenerator(fname)
    seq = fq.randseq(51)
    minoverlap, readlength, pmax, n = 25, 100, .05, 100
    for _ in range(n):
        fq.cover_seq(seq, minoverlap=minoverlap, readlength=readlength,
                     pmax=pmax)
    fq.flush()
    fastq = Fastq(fname, quiet=True)
    cfg = dict(nthreads=3, Amin=fastq.Q2A(fastq.p2Q(pmax)), maxerrors=0,
               minreadlength=random.randint(minoverlap, readlength),
               minoverlap=minoverlap, **NO_SIEVE)
    ret = _same_as_kvarq_tpu(fname, [seq], **cfg)
    assert ret['stats']['readlengths'][readlength] == n
    assert len(ret['hits']) == n
    comp = {'A': 'C', 'C': 'G', 'G': 'T', 'T': 'A'}
    seqx = ''.join(b if i % minoverlap else comp[b] for i, b in enumerate(seq))
    assert len(_same_as_kvarq_tpu(fname, [seqx], **cfg)['hits']) == 0


def test_findseqs_malformed_fastq(matcher, tmp_path):
    fname = str(tmp_path / 'bad.fastq')
    for text in ('_IDENTIFIER\nACGTACGT\n+\n########\n',
                 '@IDENTIFIER\nACGTACGT\n-\n########\n'):
        with open(fname, 'w') as f:
            f.write(text)
        for seqs in ([], ['ACGT']):
            # the port's exception, as kvarq_tpu raises its own
            with pytest.raises(TFastqFileFormatException):
                tengine.findseqs(fname, seqs)
    assert not tengine._running


def test_findseqs_sieve_equivalence(matcher):
    seqs = (
        "GAGCATGTGGAGCAACTTGTGGGAGCGCCGGGCAACGCCCTGTCTCTTAT",
        "CTGCATGTGGAGCAACTTGTGGGAGCGCCGGGCAACGCCCTGTCTCTTAT",
        "TTGACCGATGACCCCGGTTCAGGCTTCACCACAGTGTGGAACGCGGTCG",
    )
    cfg = dict(maxerrors=2, minoverlap=25, minreadlength=25, Amin='!')
    ret_off = _same_as_kvarq_tpu(FNAME, seqs, sieve='off', **cfg)
    ret_on = _same_as_kvarq_tpu(FNAME, seqs, sieve='auto', **cfg)
    assert ret_off == ret_on and len(ret_on['hits']) > 0


def test_findseqs_is_exclusive():
    ''' a second scan while one runs raises, as in kvarq_tpu '''
    tengine._running = True
    try:
        for scan in (tengine.findseqs, tengine.countseqs):
            with pytest.raises(RuntimeError, match='already running'):
                scan(FNAME, ['ACGT'])
    finally:
        tengine._running = False


# --- against tools/ref_bench.c and countseqs ---------------------------------

@pytest.fixture(scope='module')
def ref_bin(tmp_path_factory):
    binpath = hitdiff.build_ref_bench(str(tmp_path_factory.mktemp('refbench')))
    if binpath is None:
        pytest.skip('no C compiler available')
    return binpath


def _port_stream(fastq, seqs, amin, maxerrors, minoverlap, minreadlength):
    tengine.config(maxerrors=maxerrors, minoverlap=minoverlap,
                   minreadlength=minreadlength, nthreads=2, Amin=chr(amin))
    return ['%d %d %d %d %d' % h
            for h in tengine.findseqs(fastq, seqs)['hits']]


def _revcomp(s):
    comp = dict(zip('ACGT', 'TGCA'))
    return ''.join(comp.get(c, c) for c in reversed(s))


def test_ref_bench_fixture_sweep(matcher, ref_bin, tmp_path):
    ''' test_engine.fastq x maxerrors 0-3 x minoverlap (3, 10, 20) '''
    plus = ['CACCGGTGTAGGCAAGTCGTAACAAGG', 'TTTTTTTTTTGGGGGGGGGG', 'CCCC',
            'CCC']
    seqs = plus + [_revcomp(s) for s in plus]
    total = 0
    for e in range(4):
        for mo in (3, 10, 20):
            want = hitdiff.ref_hits(ref_bin, FNAME, seqs, 35, e, mo, 3,
                                    str(tmp_path))
            assert _port_stream(FNAME, seqs, 35, e, mo, 3) == want, (e, mo)
            total += len(want)
    assert total > 0


def _mtbc_seqs(names=('MTBC',)):
    set_warning()
    suites = load_testsuites(discover_testsuites([TESTSUITES]), list(names))
    covs = janalyse.Analyser().load_coverages(suites, spacing=25)
    return [c.plus_seq.bases for c in covs.values()] \
        + [c.minus_seq.bases for c in covs.values()]


def test_ref_bench_golden_5k(matcher, ref_bin, tmp_path):
    ''' the golden 5k MTBC extract against the full template bank '''
    seqs = _mtbc_seqs()
    want = hitdiff.ref_hits(ref_bin, FASTQ1, seqs, 33 + 13, 2, 25, 25,
                            str(tmp_path))
    assert len(want) == 1704
    assert _port_stream(FASTQ1, seqs, 33 + 13, 2, 25, 25) == want


@pytest.mark.parametrize('with_n', [False, True])
def test_findseqs_matches_countseqs(matcher, with_n, tmp_path):
    ''' the hit list replays into the coverage path's base counts, with
        the same stats '''
    rng = np.random.RandomState(8 + with_n)
    seqs = hitdiff.random_templates(rng, 6)
    seqs += [_revcomp(s) for s in seqs]
    corpus = str(tmp_path / 'corpus.fastq')
    hitdiff.random_corpus(corpus, seqs, 300, seed=3, with_n=with_n)
    tengine.config(maxerrors=2, minoverlap=25, minreadlength=10,
                   Amin=chr(33 + 10), sieve='off')
    found = tengine.findseqs(corpus, seqs)
    counted = tengine.countseqs(corpus, seqs)
    assert found['stats'] == counted['stats']
    for got, want in zip(bench.oracle_basecounts(found, seqs),
                         counted['basecounts']):
        np.testing.assert_array_equal(got, want)
    assert len(found['hits']) > 100


# --- Analyser ----------------------------------------------------------------

def _port_suites(names):
    ''' testsuites loaded through the port '''
    return ttestsuites.load_testsuites(
        ttestsuites.discover_testsuites([TESTSUITES]), names)


@pytest.mark.parametrize('fixture,variant', [(FASTQ1, 'Illumina 1.8+'),
                                             (FASTQ2, None)])
def test_analyser_keep_hits_matches_numpy(fixture, variant):
    ''' Analyser.scan(keep_hits=True) on the MTBC fixtures equals
        kvarq_tpu's numpy hit path: hits, coverages, stats, results '''
    set_warning()
    suites = load_testsuites(discover_testsuites([TESTSUITES]), ['MTBC'])
    fastq = Fastq(fixture, variant=variant, quiet=True)
    params = dict(maxerrors=2, minoverlap=25, minreadlength=25,
                  Amin=fastq.Q2A(13), Azero=fastq.Azero)
    jengine.config(backend='numpy', nthreads=1, **params)
    ref = janalyse.Analyser()
    ref.scan(fastq, suites, keep_hits=True)
    ref.update_testsuites()

    tengine.config(**params)
    got = analyse.Analyser()
    got.scan(TFastq(fixture, variant=variant, quiet=True),
             _port_suites(['MTBC']), keep_hits=True)
    got.update_testsuites()

    assert got.hits == ref.hits and len(got.hits) > 0
    assert got.hitseqs == ref.hitseqs
    assert got.stats == ref.stats
    assert got.results == ref.results
    for name in ref.coverages:
        assert ref.coverages[name].serialize() == \
            got.coverages[name].serialize(), name
    e1, e2 = ref.encode(hits=True), got.encode(hits=True)
    for k in ('analyses', 'stats', 'coverages', 'hits', 'hitseqs'):
        assert e1[k] == e2[k], k


def test_analyser_scan_default_keeps_hits():
    ''' Analyser().scan(fastq, suites) takes the hit path in both packages
        (keep_hits defaults to True in each), with the same hits '''
    set_warning()
    suites = load_testsuites(discover_testsuites([TESTSUITES]),
                             ['MTBC/phylo'])
    fastq = Fastq(FASTQ2, quiet=True)
    params = dict(maxerrors=2, minoverlap=25, minreadlength=25,
                  Amin=fastq.Q2A(13), Azero=fastq.Azero)
    jengine.config(backend='numpy', nthreads=1, **params)
    tengine.config(**params)
    ref, got = janalyse.Analyser(), analyse.Analyser()
    ref.scan(fastq, suites)
    got.scan(TFastq(FASTQ2, quiet=True), _port_suites(['MTBC/phylo']))
    assert ref.hits is not None and got.hits is not None
    assert got.hits == ref.hits and len(got.hits) > 0
    assert got.hitseqs == ref.hitseqs
