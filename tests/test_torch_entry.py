'''
The port's scan step, entry points and tools against kvarq_tpu on the
CPU: ``pallas_scan.scan_step_banked`` (the step of ``entry()`` on either
device) against kvarq_tpu's unsieved twin ``scan_step_fn`` (float32 on
JAX CPU), bitwise once cast to int64, dense, overflowing and compacted;
``graft_entry.entry(device='cpu')`` against ``__graft_entry__.entry()`` at
full width (the whole MTBC bank, 512 reads); ``dryrun_multichip`` on the
CPU; and the two tools' ``main()`` at tiny sizes.
'''

import contextlib
import io
import json
import logging
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvarq_tpu.engine import encode
from kvarq_tpu.engine import tensor_scan as jts
from kvarq_tpu_torch import graft_entry
from kvarq_tpu_torch.engine import pallas_scan as tps
from kvarq_tpu_torch.engine import tensor_scan as tts
from kvarq_tpu_torch.tools import bench_scaling, device_bench

from _torch_cases import case

HERE = os.path.abspath(os.path.dirname(__file__))
ROOT = os.path.dirname(HERE)


def _random_reads_case(seed, Lpad=64, B=48, nseq=6):
    ''' random templates and random reads, nothing planted '''
    rng = np.random.RandomState(seed)
    seqs = [''.join(rng.choice(list('ACGT'), rng.randint(10, 40)))
            for _ in range(nseq)]
    raw = rng.choice(np.frombuffer(b'ACGT', np.uint8), (B, Lpad))
    rl = rng.randint(0, Lpad + 1, B).astype(np.int32)
    codes = encode.encode_read_array(raw)
    codes[np.arange(Lpad)[None, :] >= rl[:, None]] = encode.CODE_READ_JUNK
    return seqs, codes, rl


CASES = {
    # (reads and templates, maxerrors, minoverlap)
    'planted nch4': (lambda: case(11, 4, B=40)[:3], 2, 25),
    'planted nch5': (lambda: case(12, 5, B=40)[:3], 1, 20),
    'random': (lambda: _random_reads_case(13), 3, 8),
}


def _counts(seqs, codes, rl, Lpad, maxerrors, minoverlap):
    ''' (reads that hit, reads the candidate screen passes) '''
    state = tps.device_arrays(tts.build_bank(seqs, Lpad, minoverlap),
                              len(seqs), 'cpu')
    c, r = torch.from_numpy(codes), torch.from_numpy(rl)
    m = tps.match_counts(c, state.K, state.nch)
    qm = state.qmeta
    w, _ = tts.mode_weights(m, r[:, None], qm[tps.ROW_D:tps.ROW_D + 1],
                            qm[tps.ROW_SEQL:tps.ROW_SEQL + 1],
                            qm[tps.ROW_VALID:tps.ROW_VALID + 1],
                            maxerrors, minoverlap)
    cand = tps.cand_counts_ref(c, r, state, maxerrors, minoverlap, state.nch)
    return int((w > 0).any(dim=1).sum()), int((cand > 0).sum())


@pytest.mark.parametrize('gather', ['none', 'below', 'above'])
@pytest.mark.parametrize('name', sorted(CASES))
def test_scan_step_banked_matches_kvarq_tpu_twin(name, gather):
    ''' the port's one scan step (``scan_step_banked`` on the CPU, as
        ``entry(device='cpu')`` runs it) against kvarq_tpu's unsieved twin
        ``scan_step_fn``: dense, overflowing its ``gather_k`` (one below the
        count), and compacted (one above it).  The port scores every row in
        the first case and screens in the other two, the same step held
        against the twin's two forms.  kvarq_tpu counts the reads that hit,
        the port the reads its candidate screen passes. '''
    make, maxerrors, minoverlap = CASES[name]
    seqs, codes, rl = make()
    Lpad, T = codes.shape[1], len(seqs)
    hits, cands = _counts(seqs, codes, rl, Lpad, maxerrors, minoverlap)
    assert 2 <= hits <= cands < len(rl) - 1
    jk = {'none': None, 'below': hits - 1, 'above': hits + 1}[gather]

    jb = jts.build_bank(seqs, Lpad, minoverlap)
    jstep = jts.scan_step_fn(Lpad, jb.G, T, maxerrors, minoverlap,
                             dtype_name='float32', gather_k=jk)
    want = jstep(jnp.asarray(codes), jnp.asarray(rl),
                 **jts.bank_device_arrays(jb, dtype=jnp.float32))

    state = tps.device_arrays(tts.build_bank(seqs, Lpad, minoverlap), T,
                              'cpu')
    *got, count = tps.scan_step_banked(
        torch.from_numpy(codes), torch.from_numpy(rl), state, maxerrors,
        minoverlap, screen=gather != 'none')
    assert count == (0 if gather == 'none' else cands)
    for g, w in zip(got, want):
        assert g.dtype == torch.int64
        np.testing.assert_array_equal(g.numpy(),
                                      np.asarray(w).astype(np.int64))
    assert int(got[1][:T].sum()) > 0


def test_entry_runs_one_step_on_both_devices(monkeypatch):
    ''' entry() on the CPU runs the card's step, ``scan_step_banked``
        screened, whose screen is the kernel's plain version '''
    seqs, _, _ = _random_reads_case(14, nseq=5)
    seqs = [s * 4 for s in seqs]
    monkeypatch.setattr(graft_entry, '_mtbc_seqs', lambda: seqs)
    calls, screens = [], []
    step, ref = tps.scan_step_banked, tps.cand_counts_ref
    monkeypatch.setattr(tps, 'scan_step_banked', lambda *a, **kw: (
        calls.append(kw['screen']) or step(*a, **kw)))
    monkeypatch.setattr(tps, 'cand_counts_ref', lambda *a: (
        screens.append(a[0].shape) or ref(*a)))
    fn, (codes, rl) = graft_entry.entry(device='cpu')
    bc, sh, sbh = fn(codes, rl)
    assert calls == [True]
    assert screens == [(graft_entry.B, graft_entry.LPAD)]
    assert int(sh[0]) >= 1 and int(sbh[0]) >= int(sh[0])


@contextlib.contextmanager
def _logger_levels():
    ''' the entry points quiet both packages' loggers: put them back '''
    loggers = [logging.getLogger(n) for n in ('kvarq', 'kvarq_tpu_torch')]
    levels = [lg.level for lg in loggers]
    try:
        yield
    finally:
        for lg, level in zip(loggers, levels):
            lg.setLevel(level)


def test_entry_matches_graft_entry():
    ''' full width: the whole MTBC bank (Lpad 128, minoverlap 25) and 512
        reads with template 0 planted in read 0 '''
    sys.path.insert(0, ROOT)
    try:
        import __graft_entry__
    finally:
        sys.path.remove(ROOT)
    with _logger_levels():
        jfn, (jcodes, jrl) = __graft_entry__.entry()
        want = jfn(jcodes, jrl)
        fn, (codes, rl) = graft_entry.entry(device='cpu')
        got = fn(codes, rl)
    assert codes.device.type == 'cpu' and codes.shape == (512, 128)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(rl.numpy(), np.asarray(jrl))
    assert got[0].shape == (encode.NBASE, 39828)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(),
                                      np.asarray(w).astype(np.int64))
    assert int(got[1][:-1].sum()) > 0


def test_entry_needs_the_card_unless_told(monkeypatch):
    ''' entry() runs on the card by default: with no card it raises, it
        does not fall back to the CPU '''
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='cuda'):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match='cuda'):
        graft_entry.dryrun_multichip(2)


def test_dryrun_multichip_cpu():
    scanner = graft_entry.dryrun_multichip(2, backend='cpu')
    assert scanner.mesh.shape == {'data': 1, 'bank': 2}
    assert int(scanner.seqhits.sum()) >= 1


def _last_json(fn, argv):
    out = io.StringIO()
    with _logger_levels(), contextlib.redirect_stdout(out):
        fn(argv)
    return json.loads(out.getvalue().strip().splitlines()[-1])


def test_device_bench_cpu():
    got = _last_json(device_bench.main, ['--device', 'cpu', '--batch', '96',
                                         '--batches', '3'])
    assert got['metric'] == 'device_bench' and got['device'] == 'cpu'
    assert got['reads'] == 288 and got['reads_per_s'] > 0
    assert got['tops'] > 0 and got['hit_weight'] > 0


def test_bench_scaling_cpu():
    got = _last_json(bench_scaling.main, ['--device', 'cpu', '--max', '2',
                                          '--reads', '192'])
    assert got['metric'] == 'scaling_efficiency'
    assert sorted(got['per_device_reads_per_s']) == ['1', '2']
    assert got['efficiency']['1'] == 1.0
