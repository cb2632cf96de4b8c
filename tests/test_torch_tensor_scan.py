'''
kvarq_tpu_torch.engine.tensor_scan and countseqs against kvarq_tpu: the
mode gating, the accumulating TensorScanner (dense, screened, and its
screen-or-dense rule) and the engine's countseqs, checked against the JAX
package and the numpy hit-path oracle.  Exact equality throughout.
'''

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvarq_tpu import engine as jengine
from kvarq_tpu.engine import encode, hitmodel, reader
from kvarq_tpu.engine import tensor_scan as jts
from kvarq_tpu_torch import engine as tengine
from kvarq_tpu_torch.engine import pallas_scan as tps
from kvarq_tpu_torch.engine import reader as treader
from kvarq_tpu_torch.engine import tensor_scan as tts

from test_tensor_scan import _hitpath_basecounts, _revcomp

HERE = os.path.abspath(os.path.dirname(__file__))
FASTQ = os.path.join(HERE, 'fastqs', 'test_engine.fastq')
PLUS = ['CACCGGTGTAGGCAAGTCGTAACAAGG', 'TTTTTTTTTTGGGGGGGGGG', 'CCCC', 'CCC']


@pytest.fixture(autouse=True)
def reset_torch_engine_config():
    ''' every test starts from the port engine's built-in defaults '''
    tengine.config(maxerrors=0, minoverlap=20, minreadlength=10,
                   nthreads=1, Amin='!', Azero='!', device='cpu',
                   sieve=os.environ.get('KVARQ_SIEVE', 'auto'),
                   batchsize=int(os.environ.get('KVARQ_BATCHSIZE', '16384')))
    yield


def test_mode_weights_closed_form():
    ''' the closed-form gating equals the four-mode enumeration
        (hitmodel.weights_for_d) for every (rl, seql, minoverlap, d) on a
        dense grid '''
    rls = torch.arange(0, 40, dtype=torch.int32)[:, None]
    for mo in (1, 3, 5, 10, 25):
        for seql in range(1, 40):
            d = np.arange(-41, seql + 3, dtype=np.int32)
            w, _ = tts.mode_weights(
                torch.zeros((len(rls), len(d))), rls,
                torch.from_numpy(d)[None, :],
                torch.full((1, len(d)), seql, dtype=torch.int32),
                torch.ones((1, len(d)), dtype=torch.int32),
                maxerrors=10 ** 6, minoverlap=mo)
            w = w.numpy()
            assert not w[0].any()      # rl == 0 never hits
            for rl in range(1, 40):
                np.testing.assert_array_equal(
                    w[rl], hitmodel.weights_for_d(d, rl, seql, mo),
                    err_msg='rl=%d seql=%d mo=%d' % (rl, seql, mo))


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_mode_weights_matches_jax(seed):
    ''' bitwise parity with the JAX function on random grids '''
    rng = np.random.RandomState(seed)
    B, Q = 48, 300
    matches = rng.randint(0, 70, (B, Q)).astype(np.float32)
    rl = rng.randint(0, 70, (B, 1)).astype(np.int32)
    d = rng.randint(-80, 80, (1, Q)).astype(np.int32)
    seql = rng.randint(1, 80, (1, Q)).astype(np.int32)
    valid = (rng.rand(1, Q) < 0.9).astype(np.int32)
    e, mo = int(rng.randint(0, 4)), int(rng.randint(1, 30))
    want = jts.mode_weights(*(jnp.asarray(a) for a in
                              (matches, rl, d, seql, valid)), e, mo)
    got = tts.mode_weights(*(torch.from_numpy(a) for a in
                             (matches, rl, d, seql, valid)), e, mo)
    for name, x, y in zip(('w', 'ov'), want, got):
        assert y.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(x), y.numpy(), err_msg=name)
    assert np.asarray(want[0]).any()


def _scan(sc, fname=FASTQ, minreadlength=5):
    stats = reader.ReaderStats()
    for batch in reader.batches([fname], ord('!'), minreadlength, stats):
        sc.scan_batch(batch)
    sc.finalize()
    return sc


def _counting_screen(monkeypatch):
    ''' a list that gets one entry per candidate-screen call '''
    launches = []
    real = tps.cand_counts

    def counting(*args):
        launches.append(1)
        return real(*args)
    monkeypatch.setattr(tps, 'cand_counts', counting)
    return launches


@pytest.mark.parametrize('mode', ['dense', 'gathered', 'adaptive'])
def test_tensor_scanner_matches_jax(mode, monkeypatch):
    ''' the port's TensorScanner equals the JAX TensorScanner: dense
        (assume_dense), screened steps of 7 reads, and a first screened
        step whose peek at the candidate count turns the scan dense '''
    seqs = ['CACCGGTGTAGGCAAGTCGTAACAAGG', 'TTTTTTTTTTGGGGGGGGGG', 'CCC']
    want = _scan(jts.TensorScanner(seqs, 1, 5))

    sc = tts.TensorScanner(seqs, 1, 5, 'cpu')
    if mode == 'dense':
        sc.assume_dense()
        assert sc.dense
    else:
        sc.SCREEN_MIN_ROWS = 5
        # two steps for the 14 reads
        monkeypatch.setattr(tts, 'score_rows', lambda device, Qp: 7)
    if mode == 'adaptive':
        sc.DENSE_AT = 1                      # the first step's count
    launches = _counting_screen(monkeypatch)
    _scan(sc)

    for a, b in zip(want.coverages(), sc.coverages()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(want.seqhits, sc.seqhits)
    np.testing.assert_array_equal(want.seqbasehits, sc.seqbasehits)
    assert sc.seqhits.sum() > 0
    assert len(launches) == {'dense': 0, 'gathered': 2, 'adaptive': 1}[mode]
    assert sc.dense == (mode != 'gathered')


def _workload(seed, sizes, planted, Lpad=64):
    ''' templates and batches of ``sizes`` random reads, the first
        ``planted`` of each batch 40 bases of a template (a hit) '''
    rng = np.random.RandomState(seed)
    acgt = np.frombuffer(b'ACGT', np.uint8)
    seqs = [bytes(rng.choice(acgt, rng.randint(60, 90))).decode()
            for _ in range(4)]
    out = []
    for B in sizes:
        raw = rng.choice(acgt, (B, Lpad))
        for b in range(planted):
            s = seqs[rng.randint(len(seqs))].encode()
            start = rng.randint(0, len(s) - 40)
            raw[b, :40] = np.frombuffer(s[start:start + 40], np.uint8)
        rl = rng.randint(40, Lpad + 1, B).astype(np.int32)
        rl[:planted] = 40
        codes = encode.encode_read_array(raw)
        codes[np.arange(Lpad)[None, :] >= rl[:, None]] = \
            encode.CODE_READ_JUNK
        out.append((codes, rl))
    return seqs, out


def _choices(sc, batches, monkeypatch):
    ''' scan ``batches`` (one step each) and finalize: whether each batch
        was screened '''
    launches = _counting_screen(monkeypatch)
    choices = []
    for codes, rl in batches:
        before = len(launches)
        sc.scan_batch(treader.RecordBatch(codes, rl, None, None))
        choices.append(len(launches) > before)
    sc.finalize()
    return choices


@pytest.mark.parametrize('workload,sizes,planted,want', [
    ('sparse', (600, 600, 300), 12, [False, False, False]),
    ('hit-dense', (1500, 1500), 1000, [True, True]),
    ('dense', (7000, 7000), 6500, [True, False]),
])
def test_gather_k_trajectory_matches_jax(workload, sizes, planted, want,
                                         monkeypatch):
    ''' the port screens a batch iff it holds more than SCREEN_MIN_ROWS
        reads and no candidate count has reached DENSE_AT (here the first
        step's peek), batch for batch; its totals equal kvarq_tpu's
        TensorScanner (Pallas backend in interpret mode, its own gather_k
        ladder); one step per batch on both '''
    seqs, batches = _workload(len(workload), sizes, planted)
    monkeypatch.setattr(tts, 'score_rows', lambda device, Qp: 1 << 14)
    jsc = jts.TensorScanner(seqs, 1, 10, backend='pallas')
    for codes, rl in batches:
        jsc.scan_batch(reader.RecordBatch(codes, rl, None, None))
    jsc.finalize()
    tsc = tts.TensorScanner(seqs, 1, 10, 'cpu')
    assert (tsc.SCREEN_MIN_ROWS, tsc.DENSE_AT) == (768, 5488)
    assert _choices(tsc, batches, monkeypatch) == want
    assert tsc.dense == (workload == 'dense')
    for a, b in zip(jsc.coverages(), tsc.coverages()):
        np.testing.assert_array_equal(a.astype(np.int64), b)
    np.testing.assert_array_equal(jsc.seqhits, tsc.seqhits)
    np.testing.assert_array_equal(jsc.seqbasehits, tsc.seqbasehits)
    assert tsc.seqhits.sum() >= planted


@pytest.mark.parametrize('edge,n,want', [
    ('rows', 768, [False]),
    ('rows', 769, [True]),
    ('flush', 5487, [True, True, True]),
    ('flush', 5488, [True, True, False]),
])
def test_screen_rule_edges(edge, n, want, monkeypatch):
    ''' the edges of the rule at its real constants: a step of 768 reads
        is scored whole and one of 769 screened; a flush maximum of 5,487
        candidates keeps the scan screening and one of 5,488 turns it
        dense (an 800-read batch, then ``n`` planted reads, all
        candidates, flushed, then 800 reads).  The coverage and the
        per-template counts equal the plain scoring of every row. '''
    seed = 11
    monkeypatch.setattr(tts, 'score_rows', lambda device, Qp: 1 << 14)
    if edge == 'rows':
        seqs, batches = _workload(seed, (n,), 12)
    else:
        seqs, (first, last) = _workload(seed, (800, 800), 12)
        _, planted = _workload(seed, (n,), n)
        batches = [first] + planted + [last]
    sc = tts.TensorScanner(seqs, 1, 10, 'cpu')
    sc.FLUSH_STEPS = 2
    seen = []
    observe = sc._observe
    monkeypatch.setattr(sc, '_observe', lambda c: seen.append(c) or
                        observe(c))
    assert _choices(sc, batches, monkeypatch) == want
    if edge == 'flush':
        # the peek at the first step, then the flush after the second
        assert seen[0] < n == seen[1]
        assert sc.dense == (n >= sc.DENSE_AT)
    plain = tts.TensorScanner(seqs, 1, 10, 'cpu')
    plain.assume_dense()
    assert _choices(plain, batches, monkeypatch) == [False] * len(batches)
    for a, b in zip(plain.coverages(), sc.coverages()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(plain.seqhits, sc.seqhits)
    np.testing.assert_array_equal(plain.seqbasehits, sc.seqbasehits)
    assert sc.seqhits.sum() >= 12


def test_score_rows_on_the_cpu():
    ''' on the CPU a scoring pass (and step) holds at most ELEM_BUDGET
        [B, Qp] elements, 64 reads at the least '''
    for Qp in (128, 40064, 10 ** 7):
        rows = tts.score_rows('cpu', Qp)
        assert 64 <= rows <= 8192
        assert rows == 64 or rows * Qp <= tts.ELEM_BUDGET


def test_adapt_gather_keeps_contexts():
    ''' the switch to dense mid-scan keeps every Lpad context and its
        accumulators, so coverages() after it stays exact: the fixture
        screened, then scored whole, counts twice the hit path's '''
    seqs = ['CACCGGTGTAGGCAAGTCGTAACAAGG', 'CCC']
    jengine.config(maxerrors=1, minoverlap=5, minreadlength=5, Amin='!',
                   nthreads=1)
    ref_bcs, _ = _hitpath_basecounts(FASTQ, seqs)

    sc = tts.TensorScanner(seqs, 1, 5, 'cpu')
    sc.SCREEN_MIN_ROWS = 4
    stats = reader.ReaderStats()
    batches = list(reader.batches([FASTQ], ord('!'), 5, stats))
    for batch in batches:
        sc.scan_batch(batch)
    (lpad,) = sc._ctx.keys()
    ctx = sc._ctx[lpad]
    assert not sc.dense and ctx['acc'] is not None
    sc._observe(sc.DENSE_AT - 1)
    assert not sc.dense
    sc._observe(sc.DENSE_AT)
    assert sc.dense
    sc._observe(0)
    assert sc.dense                                 # dense is terminal
    assert sc._ctx == {lpad: ctx} and ctx['acc'] is not None
    for batch in batches:
        sc.scan_batch(batch)
    for r, g in zip(ref_bcs, sc.coverages()):
        np.testing.assert_array_equal(2 * r, g)


@pytest.mark.parametrize('sieve', ['auto', 'off'])
@pytest.mark.parametrize('maxerrors,minoverlap,minreadlength,Amin', [
    (0, 20, 10, '!'),
    (2, 3, 3, '!'),
    (1, 10, 5, '#'),
])
def test_countseqs_matches_jax_and_oracle(maxerrors, minoverlap,
                                          minreadlength, Amin, sieve,
                                          monkeypatch):
    ''' unsieved scans screen steps above 4 reads (and the JAX package's
        scans pin their gather_k below the fixture's 14 reads), so they
        run the candidate screen '''
    launches = _counting_screen(monkeypatch)
    if sieve == 'off':
        monkeypatch.setattr(tts.TensorScanner, 'SCREEN_MIN_ROWS', 4)
        monkeypatch.setenv('KVARQ_GATHER_K', '4')
    seqs = PLUS + [_revcomp(s) for s in PLUS]
    params = dict(maxerrors=maxerrors, minoverlap=minoverlap,
                  minreadlength=minreadlength, Amin=Amin)

    jengine.config(nthreads=1, **params)
    ref_bcs, ref_stats = _hitpath_basecounts(FASTQ, seqs)
    jengine.config(sieve=sieve, **params)
    jret = jengine.countseqs(FASTQ, seqs)

    tengine.config(sieve=sieve, **params)
    ret = tengine.countseqs(FASTQ, seqs)

    for r, j, g in zip(ref_bcs, jret['basecounts'], ret['basecounts']):
        np.testing.assert_array_equal(r, g)
        np.testing.assert_array_equal(j, g)
    assert ret['stats'] == ref_stats == jret['stats']
    assert bool(launches) == (sieve == 'off')
    assert tengine.stats() == ret['stats']
    assert tengine.get_config() == jengine.get_config()


def test_config_rejects_unknown_keys():
    with pytest.raises(TypeError):
        tengine.config(backend='xla')
    with pytest.raises(TypeError):
        tengine.config(Amin='ab')
