'''
kvarq_tpu_torch.engine.tensor_scan and countseqs against kvarq_tpu: the
mode gating, the accumulating TensorScanner (dense, gathered, adaptive
gather_k) and the engine's countseqs, checked against the JAX package
and the numpy hit-path oracle.  Exact equality throughout.
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


@pytest.mark.parametrize('mode', ['dense', 'gathered', 'adaptive'])
def test_tensor_scanner_matches_jax(mode, monkeypatch):
    ''' the port's TensorScanner equals the JAX TensorScanner: dense
        (assume_dense), pinned gathered mode on sub-batches, and auto mode
        whose first-step candidate count grows gather_k '''
    seqs = ['CACCGGTGTAGGCAAGTCGTAACAAGG', 'TTTTTTTTTTGGGGGGGGGG', 'CCC']
    want = _scan(jts.TensorScanner(seqs, 1, 5))

    sc = tts.TensorScanner(seqs, 1, 5, 'cpu')
    if mode == 'dense':
        sc.assume_dense()
        assert sc.gather_k == 0
    elif mode == 'gathered':
        sc.gather_k, sc._gather_auto = 5, False
        # two steps for the 14 reads
        monkeypatch.setattr(tts, 'score_rows', lambda device, Qp: 7)
    else:
        sc.gather_k = 4                      # overflows on the first step
    launches = []
    real = tps.cand_counts

    def counting(*args):
        launches.append(1)
        return real(*args)
    monkeypatch.setattr(tps, 'cand_counts', counting)
    _scan(sc)

    for a, b in zip(want.coverages(), sc.coverages()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(want.seqhits, sc.seqhits)
    np.testing.assert_array_equal(want.seqbasehits, sc.seqbasehits)
    assert sc.seqhits.sum() > 0
    assert bool(launches) == (mode != 'dense')
    if mode == 'adaptive':
        assert sc.gather_k in sc.GATHER_BUCKETS


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


@pytest.mark.parametrize('workload,sizes,planted,want', [
    ('sparse', (600, 600, 300), 12, [768, 768, 768]),
    ('hit-dense', (1500, 1500), 1000, [1536, 1536]),
    ('dense', (7000, 7000), 6500, [0, 0]),
])
def test_gather_k_trajectory_matches_jax(workload, sizes, planted, want,
                                         monkeypatch):
    ''' auto gather_k follows kvarq_tpu's TensorScanner (Pallas backend
        in interpret mode) batch for batch -- the first step's peek and
        the flush's candidate maximum -- and the totals are equal; one
        step per batch on both '''
    seqs, batches = _workload(len(workload), sizes, planted)
    monkeypatch.setattr(tts, 'score_rows', lambda device, Qp: 1 << 14)
    jsc = jts.TensorScanner(seqs, 1, 10, backend='pallas')
    tsc = tts.TensorScanner(seqs, 1, 10, 'cpu')
    assert jsc.gather_k == tsc.gather_k == 768
    trajectory = []
    for codes, rl in batches:
        jsc.scan_batch(reader.RecordBatch(codes, rl, None, None))
        tsc.scan_batch(treader.RecordBatch(codes, rl, None, None))
        trajectory.append((jsc.gather_k, tsc.gather_k))
    jsc.finalize()
    tsc.finalize()
    assert trajectory == [(k, k) for k in want]
    assert jsc.gather_k == tsc.gather_k
    for a, b in zip(jsc.coverages(), tsc.coverages()):
        np.testing.assert_array_equal(a.astype(np.int64), b)
    np.testing.assert_array_equal(jsc.seqhits, tsc.seqhits)
    np.testing.assert_array_equal(jsc.seqbasehits, tsc.seqbasehits)
    assert tsc.seqhits.sum() >= planted


def test_score_rows_on_the_cpu():
    ''' on the CPU a scoring pass (and step) holds at most ELEM_BUDGET
        [B, Qp] elements, 64 reads at the least '''
    for Qp in (128, 40064, 10 ** 7):
        rows = tts.score_rows('cpu', Qp)
        assert 64 <= rows <= 8192
        assert rows == 64 or rows * Qp <= tts.ELEM_BUDGET


def test_adapt_gather_keeps_contexts():
    ''' a gather_k change mid-scan flushes but keeps every Lpad context, so
        coverages() after the switch stays exact (mirror of the JAX
        package's test_adapt_gather_rebuilds_in_place) '''
    seqs = ['CACCGGTGTAGGCAAGTCGTAACAAGG', 'CCC']
    jengine.config(maxerrors=1, minoverlap=5, minreadlength=5, Amin='!',
                   nthreads=1)
    ref_bcs, _ = _hitpath_basecounts(FASTQ, seqs)

    sc = _scan(tts.TensorScanner(seqs, 1, 5, 'cpu'))
    (lpad,) = sc._ctx.keys()
    sc._gather_auto, sc.gather_k = True, 768
    assert not sc._adapt_gather(lpad, 500)
    assert sc._adapt_gather(lpad, 900)
    assert sc.gather_k == 1536
    assert sc._adapt_gather(lpad, 16000)
    assert sc.gather_k == 0
    assert not sc._adapt_gather(lpad, 16000)        # dense is terminal
    assert lpad in sc._ctx
    for r, g in zip(ref_bcs, sc.coverages()):
        np.testing.assert_array_equal(r, g)


@pytest.mark.parametrize('sieve', ['auto', 'off'])
@pytest.mark.parametrize('maxerrors,minoverlap,minreadlength,Amin', [
    (0, 20, 10, '!'),
    (2, 3, 3, '!'),
    (1, 10, 5, '#'),
])
def test_countseqs_matches_jax_and_oracle(maxerrors, minoverlap,
                                          minreadlength, Amin, sieve,
                                          monkeypatch):
    ''' unsieved scans pin gather_k below the fixture's 14 reads, so they
        run the candidate screen '''
    if sieve == 'off':
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
    assert tengine.stats() == ret['stats']
    assert tengine.get_config() == jengine.get_config()


def test_config_rejects_unknown_keys():
    with pytest.raises(TypeError):
        tengine.config(backend='xla')
    with pytest.raises(TypeError):
        tengine.config(Amin='ab')
