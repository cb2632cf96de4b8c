'''
The sparse path's counters and span (kvarq_tpu_torch.engine.tensor_scan):
``scan.screened``, ``scan.scored``, ``scan.h2d_bytes`` and
``engine.copy``, recorded inside ``profiling.recording()`` alone,
against the plain screen and scoring of ``pallas_scan`` on a seeded bank
and seeded reads at four mismatches.  CPU only.
'''

import os

import numpy as np
import pytest
import torch

from kvarq_tpu_torch import engine as tengine
from kvarq_tpu_torch import profiling
from kvarq_tpu_torch.engine import encode
from kvarq_tpu_torch.engine import pallas_scan as tps
from kvarq_tpu_torch.engine import reader as treader
from kvarq_tpu_torch.engine import tensor_scan as tts

HERE = os.path.abspath(os.path.dirname(__file__))
FASTQ = os.path.join(HERE, 'fastqs', 'test_engine.fastq')
MAXERRORS, MINOVERLAP, LPAD = 4, 15, 64


@pytest.fixture(autouse=True)
def nothing_left_recorded():
    profiling.collect()
    yield
    profiling.collect()


@pytest.fixture
def engine_config(monkeypatch):
    ''' the engine's configuration, restored after the test '''
    monkeypatch.setattr(tengine, '_config', dict(tengine._config))
    monkeypatch.setattr(tengine, '_extra_config',
                        dict(tengine._extra_config))
    return tengine.config


def _workload(seed, B=300, planted=120, empty=20):
    ''' six random templates and one batch of ``B`` random reads: the
        first ``planted`` cut from a template with up to three
        substitutions, the last ``empty`` of length 0 '''
    rng = np.random.RandomState(seed)
    acgt = np.frombuffer(b'ACGT', np.uint8)
    seqs = [bytes(rng.choice(acgt, rng.randint(40, 80))).decode()
            for _ in range(6)]
    raw = rng.choice(acgt, (B, LPAD))
    rl = rng.randint(MINOVERLAP, LPAD + 1, B).astype(np.int32)
    for b in range(planted):
        s = np.frombuffer(seqs[rng.randint(len(seqs))].encode(), np.uint8)
        n = rng.randint(MINOVERLAP + 5, min(len(s), LPAD) + 1)
        start = rng.randint(0, len(s) - n + 1)
        raw[b, :n] = s[start:start + n]
        for p in rng.choice(n, rng.randint(0, 4), replace=False):
            raw[b, p] = acgt[(np.flatnonzero(acgt == raw[b, p])[0] + 1) % 4]
        rl[b] = n
    rl[B - empty:] = 0
    codes = encode.encode_read_array(raw)
    codes[np.arange(LPAD)[None, :] >= rl[:, None]] = encode.CODE_READ_JUNK
    return seqs, codes, rl


def _scanner(seqs, dense, rows, monkeypatch):
    ''' a scanner that screens steps of more than 4 reads unless
        ``dense``, ``rows`` reads a step, a flush every two steps '''
    monkeypatch.setattr(tts, 'score_rows', lambda device, Qp: rows)
    monkeypatch.setattr(tts.TensorScanner, 'FLUSH_STEPS', 2)
    sc = tts.TensorScanner(seqs, MAXERRORS, MINOVERLAP, 'cpu')
    sc.SCREEN_MIN_ROWS = 4
    sc.dense = dense
    return sc


def _scan(sc, codes, rl):
    sc.scan_batch(treader.RecordBatch(codes, rl, None, None))
    sc.finalize()


def _plain(seqs, codes, rl):
    ''' the plain screen's passing reads and the plain scoring of every
        read on the scanner's bank '''
    sc = tts.TensorScanner(seqs, MAXERRORS, MINOVERLAP, 'cpu')
    state = sc._context(LPAD)['state']
    c, r = torch.from_numpy(codes), torch.from_numpy(rl)
    passing = int((tps.cand_counts_ref(c, r, state, MAXERRORS, MINOVERLAP,
                                       state.nch) > 0).sum())
    bc, sh, sbh = tps.score_candidates_ref(c, r, state, MAXERRORS,
                                           MINOVERLAP)
    return passing, bc.numpy(), sh.numpy()[:-1], sbh.numpy()[:-1]


@pytest.mark.parametrize('seed', [3, 2 ** 31 + 17])
@pytest.mark.parametrize('mode', ['gathered', 'dense'])
def test_counters_against_the_plain_screen(mode, seed, monkeypatch):
    seqs, codes, rl = _workload(seed)
    passing, bc, sh, sbh = _plain(seqs, codes, rl)
    assert 0 < passing < np.count_nonzero(rl)
    # 64 reads a step: five steps, three flushes
    sc = _scanner(seqs, mode == 'dense', 64, monkeypatch)
    with profiling.recording():
        _scan(sc, codes, rl)
        rec = profiling.collect()
    counts = rec['counts']
    if mode == 'gathered':
        assert counts['scan.screened'] == np.count_nonzero(rl) < len(rl)
        assert counts['scan.scored'] == passing
    else:
        assert 'scan.screened' not in counts
        assert counts['scan.scored'] == len(rl)
    assert set(counts) <= {'scan.screened', 'scan.scored', 'scan.h2d_bytes'}
    assert counts['scan.h2d_bytes'] == codes.nbytes + rl.nbytes
    copies = [s for s in rec['spans'] if s[0] == 'engine.copy']
    assert len(copies) == 5 and all(a <= b for _, _, a, b in copies)
    # the coverage is the plain scoring's, recorded or not
    np.testing.assert_array_equal(sc.basecounts[LPAD], bc)
    np.testing.assert_array_equal(sc.seqhits, sh)
    np.testing.assert_array_equal(sc.seqbasehits, sbh)
    assert sh.sum() > 0
    quiet = _scanner(seqs, sc.dense, 64, monkeypatch)
    _scan(quiet, codes, rl)
    np.testing.assert_array_equal(quiet.basecounts[LPAD], bc)


def test_adapted_counts_a_growth_and_the_switch_to_dense(monkeypatch):
    ''' the first step's peek leaves the scan screening below DENSE_AT;
        the flush's candidate maximum at DENSE_AT (patched to the
        fixture's candidates) then turns it dense, which is terminal '''
    seqs, codes, rl = _workload(5)
    passing = _plain(seqs, codes, rl)[0]
    sc = _scanner(seqs, False, 300, monkeypatch)
    sc.DENSE_AT = passing + 1
    with profiling.recording():
        sc.scan_batch(treader.RecordBatch(codes, rl, None, None))
        assert not sc.dense
        sc.DENSE_AT = passing
        sc.finalize()
        assert sc.dense
        sc._observe(0)
        assert sc.dense
        sc.scan_batch(treader.RecordBatch(codes, rl, None, None))
        sc.finalize()
        counts = profiling.collect()['counts']
    assert set(counts) == {'scan.screened', 'scan.scored', 'scan.h2d_bytes'}
    # one screened step, then one step scored whole
    assert counts['scan.screened'] == np.count_nonzero(rl)
    assert counts['scan.scored'] == passing + len(rl)
    assert counts['scan.h2d_bytes'] == 2 * (codes.nbytes + rl.nbytes)


def test_nothing_is_recorded_outside_recording(monkeypatch):
    seqs, codes, rl = _workload(7)
    for dense in (False, True):
        sc = _scanner(seqs, dense, 64, monkeypatch)
        _scan(sc, codes, rl)
        sc._observe(10 ** 6)
    assert profiling.collect() == {'spans': [], 'counts': {}}


def test_copy_span_lies_inside_the_engine_scan_span(monkeypatch,
                                                   engine_config):
    ''' countseqs with no sieve (a 4-base seed at four mismatches) and
        steps above 4 reads screened: every step copies inside
        ``engine.scan`` on the scan's thread '''
    monkeypatch.setattr(tts.TensorScanner, 'SCREEN_MIN_ROWS', 4)
    engine_config(maxerrors=MAXERRORS, minoverlap=20, minreadlength=10,
                  nthreads=1, Amin='!', Azero='!', device='cpu',
                  sieve='auto', batchsize=16384)
    seqs = ['CACCGGTGTAGGCAAGTCGTAACAAGG', 'TTTTTTTTTTGGGGGGGGGG', 'CCCC']
    seqs += [s[::-1].translate(str.maketrans('ACGT', 'TGCA')) for s in seqs]
    want = tengine.countseqs(FASTQ, seqs)
    with profiling.recording():
        got = tengine.countseqs(FASTQ, seqs)
        rec = profiling.collect()
    for a, b in zip(want['basecounts'], got['basecounts']):
        np.testing.assert_array_equal(a, b)
    assert sum(int(b.sum()) for b in got['basecounts']) > 0
    copies = [s for s in rec['spans'] if s[0] == 'engine.copy']
    scans = [s for s in rec['spans'] if s[0] == 'engine.scan']
    assert copies and scans
    for _, thread, a, b in copies:
        assert any(t == thread and s <= a <= b <= e
                   for _, t, s, e in scans)
    # every read of the fixture is 51 bases long, and screened
    assert rec['counts']['scan.screened'] == \
        got['stats']['records_parsed'] == 14
    assert 0 < rec['counts']['scan.scored'] <= 14
