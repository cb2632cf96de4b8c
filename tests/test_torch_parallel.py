'''
The scale-out layer of the port (kvarq_tpu_torch.parallel) against
kvarq_tpu.parallel on the virtual 8-device JAX CPU mesh, with exact
equality: the sharded scanner (gathered and dense, 4- and 5-channel banks,
every mesh shape) against kvarq_tpu's ShardedScanner and the hit-list
path, the sharded hit matcher against the numpy matcher, the engine and
``scan --mesh`` against kvarq_tpu's, and the bank split itself.  On the
CPU every mesh entry is the ``cpu`` device and the candidate screen is its
plain version.
'''

import json
import os

import numpy as np
import pytest
import torch

from kvarq_tpu import cli as jcli
from kvarq_tpu import engine as jengine
from kvarq_tpu import parallel as jparallel
from kvarq_tpu.engine import encode, reader
from kvarq_tpu.engine.match_numpy import NumpyMatcher
from kvarq_tpu.log import set_warning
from kvarq_tpu_torch import cli, parallel
from kvarq_tpu_torch import engine as tengine
from kvarq_tpu_torch.engine import pallas_scan as tps
from kvarq_tpu_torch.engine.tensor_scan import TensorScanner

from _torch_log import restore_log_levels  # noqa: F401

HERE = os.path.abspath(os.path.dirname(__file__))
ROOT = os.path.dirname(HERE)
TESTSUITES = os.path.join(ROOT, 'testsuites')
FNAME = os.path.join(HERE, 'fastqs', 'test_engine.fastq')
FASTQ2 = os.path.join(HERE, 'fastqs', 'N0116_1_hits_1k.fastq')
COMPL = {'A': 'T', 'T': 'A', 'C': 'G', 'G': 'C', 'N': 'N'}
SHAPES = [(8, 1), (4, 2), (2, 4), (1, 8)]
# tests/test_parallel.py's bank; with nch 5 one template carries an N
PLUS = {4: ['CACCGGTGTAGGCAAGTCGTAACAAGG', 'TTTTTTTTTTGGGGGGGGGG', 'CCCC',
            'CCC'],
        5: ['CACCGGTGTAGNCAAGTCGTAACAAGG', 'TTTTTTTTTTGGGGGGGGGG', 'CCCC',
            'CCC']}


def _revcomp(s):
    return ''.join(COMPL[c] for c in reversed(s))


def _seqs(nch):
    return PLUS[nch] + [_revcomp(s) for s in PLUS[nch]]


@pytest.fixture(autouse=True)
def reset_torch_engine_config():
    ''' every test starts from the port engine's built-in defaults, on the
        CPU with no mesh, and leaves no mesh behind '''
    tengine.config(maxerrors=0, minoverlap=20, minreadlength=10,
                   nthreads=1, Amin='!', Azero='!', device='cpu', mesh='',
                   sieve=os.environ.get('KVARQ_SIEVE', 'auto'),
                   batchsize=int(os.environ.get('KVARQ_BATCHSIZE', '16384')))
    yield
    tengine.config(mesh='')


def _need8():
    import jax
    if len(jax.devices()) < 8:
        pytest.skip('needs 8 (virtual) devices')


def _scan(scanner, batchsize=16):
    stats = reader.ReaderStats()
    for batch in reader.batches([FNAME], ord('!'), 5, stats,
                                batchsize=batchsize):
        scanner.scan_batch(batch)
    return ([np.asarray(c, np.int64) for c in scanner.coverages()],
            scanner.seqhits, scanner.seqbasehits)


_REF = {}


def _reference(nch, n_data, n_bank):
    ''' (kvarq_tpu's ShardedScanner on the JAX mesh, the numpy hit path's
        basecounts and stats), computed once per bank and shape '''
    key = (nch, n_data, n_bank)
    if key not in _REF:
        seqs = _seqs(nch)
        jengine.config(maxerrors=1, minoverlap=5, minreadlength=5, Amin='!',
                       backend='numpy', nthreads=1)
        ret = jengine.findseqs(FNAME, seqs)
        hit = ([np.zeros((encode.NBASE, len(s)), np.int64) for s in seqs],
               np.asarray(ret['stats']['nseqhits']),
               np.asarray(ret['stats']['nseqbasehits']))
        for h, hs in zip(ret['hits'], ret['hitseqs']):
            codes = encode.encode_read(hs.encode('latin-1'))
            start = max(0, h.seq_pos)
            for i in range(h.length):
                hit[0][h.seq_nr][codes[i], start + i] += 1
        jax_sc = jparallel.ShardedScanner(
            seqs, maxerrors=1, minoverlap=5,
            mesh=jparallel.make_mesh(n_data, n_bank), backend='xla')
        _REF[key] = (_scan(jax_sc), hit)
    return _REF[key]


def _assert_equal(got, want):
    for t, (g, w) in enumerate(zip(got[0], want[0])):
        np.testing.assert_array_equal(g, w, err_msg='template %d' % t)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.parametrize('n_data,n_bank', SHAPES)
@pytest.mark.parametrize('dense', [False, True], ids=['gathered', 'dense'])
@pytest.mark.parametrize('nch', [4, 5])
def test_sharded_equals_kvarq_tpu_and_hitpath(nch, dense, n_data, n_bank):
    ''' the port's ShardedScanner equals kvarq_tpu's ShardedScanner on the
        same mesh shape and the hit-list path, bit for bit; gathered with
        every 8-row slice screened (screen, compaction and the scoring of
        every candidate all run) '''
    _need8()
    jax_ref, hit_ref = _reference(nch, n_data, n_bank)
    assert int(hit_ref[1].sum()) > 0
    sc = parallel.ShardedScanner(_seqs(nch), 1, 5, parallel.make_mesh(
        n_data, n_bank, backend='cpu'))
    sc.B_LOCAL, sc.SCREEN_MIN_ROWS = 8, 2
    if dense:
        sc.assume_dense()
    got = _scan(sc)
    assert sc.context(64).nch == nch
    _assert_equal(got, jax_ref)
    _assert_equal(got, hit_ref)


@pytest.mark.parametrize('n_data,n_bank', [(4, 2), (2, 1)])
@pytest.mark.parametrize('dense', [False, True], ids=['gathered', 'dense'])
def test_sharded_equals_kvarq_tpu_pallas(dense, n_data, n_bank):
    ''' the port's ShardedScanner equals kvarq_tpu's sharded Pallas step in
        interpret mode (tests/test_parallel.py::
        test_sharded_pallas_equals_hitpath).  There the step is dense
        whenever gather_k = min(512, B_LOCAL) covers the padded slice, so
        the reference takes 640-row slices to run its screen. '''
    _need8()
    seqs = _seqs(4)
    ref = jparallel.ShardedScanner(seqs, 1, 5, backend='pallas',
                                   mesh=jparallel.make_mesh(n_data, n_bank))
    ref.B_LOCAL, ref.TB, ref.TQ = 640, 128, 128
    sc = parallel.ShardedScanner(seqs, 1, 5, parallel.make_mesh(
        n_data, n_bank, backend='cpu'))
    sc.B_LOCAL, sc.SCREEN_MIN_ROWS = 8, 2
    if dense:
        ref.assume_dense()
        sc.assume_dense()
        assert ref.dense
    want = _scan(ref)
    assert int(want[1].sum()) > 0
    _assert_equal(_scan(sc), want)


@pytest.mark.parametrize('nch', [4, 5])
def test_sharded_matcher_equals_kvarq_tpu_pallas(nch):
    ''' the port's ShardedMatcher gives kvarq_tpu's sharded Pallas flag
        step's triplets (interpret mode, 2x2; tests/test_parallel.py::
        test_sharded_matcher_parity) '''
    _need8()
    seqs = _seqs(nch)
    ref = jparallel.ShardedMatcher(seqs, 1, 5, mesh=jparallel.make_mesh(2, 2),
                                   backend='pallas', b_local=8, TB=8, TQ=128)
    matcher = parallel.ShardedMatcher(
        seqs, 1, 5, parallel.make_mesh(2, 2, backend='cpu'), b_local=8)
    stats = reader.ReaderStats()
    n = 0
    for batch in reader.batches([FNAME], ord('!'), 5, stats, batchsize=32):
        want = sorted(map(tuple, ref.match_batch(batch)))
        assert sorted(map(tuple, matcher.match_batch(batch))) == want
        n += len(want)
    assert n > 0


@pytest.mark.parametrize('dense', [False, True], ids=['gathered', 'dense'])
def test_every_entry_screens_in_gathered_mode(dense, monkeypatch):
    ''' gathered: the candidate screen runs once per step on every mesh
        entry against that entry's bank shard; dense: never '''
    calls = []
    screen = tps.cand_counts

    def counting(codes, rl, state, *args):
        calls.append((len(codes), int(state.tseg.min())))
        return screen(codes, rl, state, *args)

    counting.launches = 0
    monkeypatch.setattr(tps, 'cand_counts', counting)
    seqs = _seqs(4)
    sc = parallel.ShardedScanner(seqs, 1, 5, parallel.make_mesh(
        2, 2, backend='cpu'))
    sc.B_LOCAL, sc.SCREEN_MIN_ROWS = 4, 2
    if dense:
        sc.assume_dense()
    B = 16
    codes = np.full((B, 64), encode.CODE_READ_JUNK, np.uint8)
    rl = np.zeros(B, np.int32)
    sc.scan_batch(reader.RecordBatch(codes, rl, np.zeros(B, np.int64),
                                     None))
    if dense:
        assert calls == []
    else:
        # 2 steps of 8 rows, 4 entries each; shard j's columns start at
        # template lo_j of the global numbering
        los = [lo for lo, _ in sc.context(64).ranges]
        assert sorted(calls) == sorted([(4, lo) for lo in los] * 4)


def test_odd_batch_padding():
    ''' batches not divisible by the data axis are padded with rl=0 rows
        (mirror of tests/test_parallel.py::test_odd_batch_padding) '''
    seqs = ['CACCGGTGTAGGCAAGTCGTAACAA']
    sc = parallel.ShardedScanner(seqs, 0, 10, parallel.make_mesh(
        8, 1, backend='cpu'))
    B, Lpad = 13, 64  # 13 % 8 != 0
    raw = np.full((B, Lpad), ord('G'), dtype=np.uint8)
    raw[3, :25] = np.frombuffer(seqs[0].encode(), dtype=np.uint8)
    sc.scan_batch(reader.RecordBatch(
        encode.encode_read_array(raw), np.full(B, 40, dtype=np.int32),
        np.zeros(B, dtype=np.int64), raw))
    sc.finalize()
    assert int(sc.seqhits[0]) == 1
    assert sc.coverages()[0].sum(axis=0)[:25].tolist() == [1] * 25


def test_dryrun():
    sc = parallel.dryrun(8, 'cpu')
    assert sc.mesh.shape == {'data': 4, 'bank': 2}


def test_mesh_shapes_and_devices(monkeypatch):
    assert parallel.parse_mesh('4x2', 'cpu').shape == {'data': 4, 'bank': 2}
    assert parallel.parse_mesh('3', 'cpu').shape == {'data': 3, 'bank': 1}
    auto = parallel.parse_mesh('auto', 'cpu')
    assert auto.size == 1 and auto.first == torch.device('cpu')
    for bad in ('x', '2y2', 'ax2', '0x1'):
        with pytest.raises(ValueError):
            parallel.parse_mesh(bad, 'cpu')
    # CUDA: never a silent fallback to the CPU; no more entries than cards
    # unless the devices are given
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError):
        parallel.parse_mesh('2x2', 'cuda')
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 1)
    assert parallel.parse_mesh('auto', 'cuda').shape == {'data': 1,
                                                         'bank': 1}
    with pytest.raises(ValueError):
        parallel.parse_mesh('2x2', 'cuda')
    mesh = parallel.make_mesh(2, 2, ['cuda:0'] * 4)
    assert mesh.devices == [[torch.device('cuda:0')] * 2] * 2


@pytest.mark.parametrize('nch', [4, 5])
def test_shard_states(nch):
    ''' every shard's BankState: common G and Qp, the whole bank's channel
        count (also on a shard with no N), the kernel's sentinel on every
        padding byte, tseg in global numbering, K ~1/n_bank of the whole
        (mirror of tests/test_bank_scale.py::test_bank_shard_memory_split) '''
    seqs = _seqs(nch) * 3
    Lpad = 64
    whole = parallel.ShardBank(seqs, Lpad, 1, 5)
    bank = parallel.ShardBank(seqs, Lpad, 4, 5)
    jbank = jparallel.ShardBank(seqs, Lpad, 4, 5)
    assert bank.G == jbank.G and bank.ranges == jbank.ranges
    assert bank.Qp % tps.QALIGN == 0 and bank.Qp >= bank.G + Lpad - 1
    seen = set()
    for j, ((lo, hi), sub) in enumerate(zip(bank.ranges, bank.sub)):
        st = bank.state(j, 'cpu')
        assert (st.G, st.Qp, st.nch, st.T) == (bank.G, bank.Qp, nch,
                                                len(seqs))
        assert st.K.shape == (Lpad * nch, bank.Qp)
        # bank bytes: the sub-bank at Lpad-1, the sentinel everywhere else
        kb = st.bank.numpy()
        inner = kb[Lpad - 1:Lpad - 1 + sub.G]
        want = np.where(sub.codes < nch, sub.codes, tps.BANK_SENTINEL)
        np.testing.assert_array_equal(inner, want)
        assert (kb[:Lpad - 1] == tps.BANK_SENTINEL).all()
        assert (kb[Lpad - 1 + sub.G:] == tps.BANK_SENTINEL).all()
        tseg = st.tseg.numpy()
        real = tseg[tseg != len(seqs)]
        assert real.min() >= lo and real.max() < hi
        seen |= set(real.tolist())
        assert bank.state(j, 'cpu') is st
    assert seen == set(range(len(seqs)))
    assert bank.G <= -(-whole.G // 4) + max(map(len, seqs)) + Lpad


def test_empty_shards():
    ''' more bank shards than templates: the empty shards hold no state
        and contribute nothing '''
    seqs = ['CACCGGTGTAGGCAAGTCGTAACAAGG', 'TTTTTTTTTTGGGGGGGGGG']
    sc = parallel.ShardedScanner(seqs, 1, 5, parallel.make_mesh(
        1, 4, backend='cpu'))
    got = _scan(sc)
    assert [sc.context(64).state(j, 'cpu') is None for j in range(4)] \
        == [False, False, True, True]
    _assert_equal(got, _scan(TensorScanner(seqs, 1, 5, 'cpu')))


@pytest.mark.parametrize('n_data,n_bank', [(4, 2), (8, 1), (2, 2)])
@pytest.mark.parametrize('nch', [4, 5])
def test_sharded_matcher_parity(nch, n_data, n_bank):
    ''' the port's ShardedMatcher gives exactly the numpy matcher's
        (read, template, shift) triplets '''
    seqs = _seqs(nch)
    matcher = parallel.ShardedMatcher(
        seqs, 1, 5, parallel.make_mesh(n_data, n_bank, backend='cpu'),
        b_local=4)
    ref = NumpyMatcher(seqs, 1, 5)
    stats = reader.ReaderStats()
    n = 0
    for batch in reader.batches([FNAME], ord('!'), 5, stats, batchsize=32):
        want = sorted(map(tuple, ref.match_batch(batch)))
        got = sorted(map(tuple, matcher.match_batch(batch)))
        assert got == want
        n += len(want)
    assert n > 0


@pytest.mark.parametrize('sieve', ['auto', 'off'])
def test_engine_mesh_equals_plain(sieve):
    ''' engine.findseqs and engine.countseqs with a mesh configured equal
        the plain port scan and kvarq_tpu's with the same mesh: the same
        hits (incl. file_pos), basecounts and stats '''
    _need8()
    seqs = _seqs(4)
    params = dict(maxerrors=1, minoverlap=5, minreadlength=5, Amin='!')
    jengine.config(mesh='4x2', sieve=sieve, nthreads=1, **params)
    jhits = jengine.findseqs(FNAME, seqs)
    jcounts = jengine.countseqs(FNAME, seqs)
    out = []
    for mesh in ('', '4x2', parallel.make_mesh(2, 2, ['cpu'] * 4)):
        tengine.config(mesh=mesh, sieve=sieve, **params)
        out.append((tengine.findseqs(FNAME, seqs),
                    tengine.countseqs(FNAME, seqs)))
    assert len(jhits['hits']) > 0
    for hits, counts in out:
        assert hits == jhits
        assert counts['stats'] == jcounts['stats']
        for g, w in zip(counts['basecounts'], jcounts['basecounts']):
            np.testing.assert_array_equal(g, w)


@pytest.fixture(scope='module')
def bank_and_reads():
    ''' tests/test_bank_scale.py's 1,040-template SNP bank and 256 reads,
        and kvarq_tpu's single-device scan of them '''
    import test_bank_scale
    seqs, batch = test_bank_scale.bank_and_reads.__wrapped__()
    single = test_bank_scale._scan(seqs, batch, 1, 1)
    return seqs, batch, single


@pytest.mark.parametrize('n_data,n_bank', [(1, 8), (2, 4)])
def test_bank_sharded_equals_single_device(bank_and_reads, n_data, n_bank):
    ''' the bank axis at scale (mirror of tests/test_bank_scale.py), with
        slices above 32 rows screened so the screen runs '''
    _need8()
    seqs, batch, single = bank_and_reads
    sc = parallel.ShardedScanner(seqs, 2, 25, parallel.make_mesh(
        n_data, n_bank, backend='cpu'))
    sc.SCREEN_MIN_ROWS = 32
    sc.scan_batch(batch)
    got = sc.coverages()
    assert int(single.seqhits.sum()) >= 64
    np.testing.assert_array_equal(sc.seqhits, single.seqhits)
    np.testing.assert_array_equal(sc.seqbasehits, single.seqbasehits)
    ref = single.coverages()
    diff = [t for t in range(len(seqs))
            if not np.array_equal(ref[t].astype(np.int64), got[t])]
    assert not diff, 'coverages differ for templates %r' % diff[:10]


def _cli_json(main, tmp_path, name, args):
    out = str(tmp_path / (name + '.json'))
    main(['-q', '-t', TESTSUITES, 'scan', '-l', 'MTBC/phylo', '-f', *args,
          FASTQ2, out])
    with open(out) as fd:
        return json.load(fd)


@pytest.mark.parametrize('hits', [False, True], ids=['coverage', 'hits'])
def test_cli_scan_mesh(hits, tmp_path):
    ''' ``scan --mesh`` (coverage path, and -H through the sharded screen)
        equals kvarq_tpu's ``scan --mesh 4x2`` on the virtual mesh
        (tests/test_cli.py::test_scan_mesh and ::test_scan_mesh_hits) '''
    _need8()
    set_warning()
    extra = ['-H'] if hits else []
    try:
        ref = _cli_json(jcli.main, tmp_path, 'ref',
                        ['--mesh', '4x2', '-t', '1', *extra])
    finally:
        jengine.config(mesh='')
    keys = ['analyses', 'coverages', 'stats'] + (['hits', 'hitseqs']
                                                 if hits else [])
    if hits:
        assert ref['hits']
    for mesh in ('4x2', 'auto', '1x3'):
        got = _cli_json(cli.main, tmp_path, 'port_' + mesh,
                        ['--backend', 'cpu', '--mesh', mesh, *extra])
        for key in keys:
            assert got[key] == ref[key], (mesh, key)


def test_cli_scan_mesh_refuses_bad_spec(tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(['scan', '-l', 'MTBC', '-f', '--backend', 'cpu', '--mesh',
                  '2y2', FASTQ2, str(tmp_path / 'out.json')])
    assert e.value.code == jcli.ERROR_COMMAND_LINE_SWITCH
    assert 'mesh spec' in capsys.readouterr().err
