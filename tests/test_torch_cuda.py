'''
kvarq_tpu_torch on the card: the CUDA kernels (the candidate screen K1,
the exact scoring S1 and the hit extraction H1) against their plain
PyTorch versions, the hit matchers' one wait on the host per batch, the scan
step with no host round trip, scanner, screening matcher and
``findseqs`` on CUDA against the same code on the CPU, and the sharded
scanner and matcher (on a mesh that repeats one card, and over every
card) against the single-device ones.  Skipped without
an NVIDIA GPU (a CUDA kernel has no CPU mode); this file imports no jax,
so it runs where jax is absent:

    python -m pytest tests/test_torch_cuda.py -m cuda
'''

import os

import numpy as np
import pytest
import torch

from kvarq_tpu_torch import engine as tengine
from kvarq_tpu_torch import parallel
from kvarq_tpu_torch.engine import encode, match_pallas, reader
from kvarq_tpu_torch.engine import pallas_scan as tps
from kvarq_tpu_torch.engine import tensor_scan as tts

from _torch_cases import case
from test_engine import SEQS7

pytestmark = pytest.mark.cuda
HERE = os.path.dirname(os.path.abspath(__file__))
FASTQ = os.path.join(HERE, 'fastqs', 'test_engine.fastq')
TESTSUITES = os.path.join(os.path.dirname(HERE), 'testsuites')


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (CUDA kernel, no CPU mode)')
    return torch.device('cuda')


@pytest.mark.parametrize('nch', [4, 5])
@pytest.mark.parametrize('Lpad,B', [(64, 77), (192, 130)])
def test_cand_screen_kernel_matches_ref(cuda, nch, Lpad, B):
    seqs, codes, rl, bank = case(5 + Lpad, nch, B=B, Lpad=Lpad, nseq=9)
    state = tps.device_arrays(bank, len(seqs), cuda)
    c, r = torch.from_numpy(codes).to(cuda), torch.from_numpy(rl).to(cuda)
    for e, mo in ((0, 25), (2, 25), (3, 8)):
        before = tps.cand_counts.launches
        got = tps.cand_counts(c, r, state, e, mo, nch)
        torch.cuda.synchronize()
        assert tps.cand_counts.launches == before + 1
        want = tps.cand_counts_ref(c, r, state, e, mo, nch)
        np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
        assert (want > 0).any()


_MTBC = []


def _mtbc_seqs():
    ''' plus and minus strands of the MTBC templates (loaded once) '''
    if not _MTBC:
        from kvarq_tpu_torch import analyse, testsuites
        suites = testsuites.load_testsuites(
            testsuites.discover_testsuites([TESTSUITES]), ['MTBC'])
        covs = analyse.Analyser().load_coverages(suites, spacing=25)
        _MTBC.extend([c.plus_seq.bases for c in covs.values()]
                     + [c.minus_seq.bases for c in covs.values()])
    return list(_MTBC)


def _planted_reads(rng, seqs, B, Lpad, nch):
    ''' random ACGT reads (N sprinkled in with nch 5), every other one
        carrying a piece of a template with a few substitutions '''
    acgt = np.frombuffer(b'ACGT', np.uint8)
    raw = rng.choice(acgt, (B, Lpad))
    rl = rng.randint(0, Lpad + 1, B)
    for b in range(0, B, 2):
        s = np.frombuffer(seqs[rng.randint(len(seqs))].encode(), np.uint8)
        n = min(len(s), Lpad)
        start = rng.randint(0, len(s) - n + 1)
        off = rng.randint(0, Lpad - n + 1)
        raw[b, off:off + n] = s[start:start + n]
        raw[b, off + rng.randint(0, n, 2)] = rng.choice(acgt, 2)
        rl[b] = max(rl[b], off + n)
    if nch == 5:
        raw[rng.rand(B, Lpad) < 0.03] = ord('N')
    codes = encode.encode_read_array(raw)
    codes[np.arange(Lpad)[None, :] >= rl[:, None]] = encode.CODE_READ_JUNK
    return codes, rl.astype(np.int32)


def _bank_seqs(bank, nch):
    ''' one short template (a one-tile Qp at Lpad <= 64) or the MTBC
        bank; with nch 5 some templates carry an N '''
    seqs = ['ACGTTGCAACGGTTACCGTA'] if bank == 'one tile' else _mtbc_seqs()
    if nch == 5:
        seqs = [s[:7] + 'N' + s[8:] if k % 3 == 0 else s
                for k, s in enumerate(seqs)]
    return seqs


def _screen_equal(codes, rl, state, nch, params=((2, 25), (0, 25), (3, 8))):
    ''' K1 equals cand_counts_ref exactly (counts, not flags) for every
        ``(e, mo)``; :returns: the candidate reads of the first '''
    found = None
    for e, mo in params:
        before = tps.cand_counts.launches
        got = tps.cand_counts(codes, rl, state, e, mo, nch)
        torch.cuda.synchronize()
        assert tps.cand_counts.launches == before + 1
        want = tps.cand_counts_ref(codes, rl, state, e, mo, nch)
        np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy(),
                                      err_msg='e=%d mo=%d' % (e, mo))
        found = int((want > 0).sum()) if found is None else found
    return found


# the hitdiff sweep's errors and overlaps, and the CLI's defaults
K1_PARAMS = ((0, 3), (1, 25), (2, 25), (3, 8))


def _k1_reads(B, Lpad, nch, seqs, seed):
    ''' planted reads, every fifth given length 0 with its bases kept '''
    codes, rl = _planted_reads(np.random.RandomState(seed), seqs, B, Lpad,
                               nch)
    rl[::5] = 0
    return codes, rl


@pytest.mark.parametrize('bank', ['one tile', 'MTBC'])
@pytest.mark.parametrize('nch', [4, 5])
@pytest.mark.parametrize('Lpad', [36, 64, 128, 192])
@pytest.mark.parametrize('B', [1, 127, 130, 577, 16384])
def test_tensor_core_screen_equals_ref(cuda, B, Lpad, nch, bank):
    ''' K1 on S1's pipeline (one block per SM, the row tiles of the batch
        cut into equal ranges of stages) at every read padding the reader
        makes (and 36, whose depth is no multiple of 32 bytes; 192 with nch
        5 takes two A tiles), both channel counts, a one-tile and the whole
        MTBC bank (at Lpad 128 its Qp, 40,064, is no multiple of the
        512-column group), from one read, one and two past a row tile, to
        a main-path batch, with reads of length 0 '''
    seqs = _bank_seqs(bank, nch)
    state = tps.device_arrays(tts.build_bank(seqs, Lpad, 25), len(seqs), cuda)
    assert state.nch == nch
    if bank == 'one tile' and Lpad <= 64:
        assert state.Qp == tps.QALIGN
    if bank == 'MTBC' and Lpad == 128:
        assert state.Qp % tps.S1_GROUP
    codes, rl = _k1_reads(B, Lpad, nch, seqs, B + Lpad + nch)
    found = _screen_equal(torch.from_numpy(codes).to(cuda),
                          torch.from_numpy(rl).to(cuda), state, nch,
                          K1_PARAMS)
    assert found > 0 or B == 1


@pytest.mark.parametrize('Lpad,n_bank,B', [(128, 2, 577), (192, 3, 130)])
@pytest.mark.parametrize('nch', [4, 5])
def test_tensor_core_screen_on_bank_shards(cuda, nch, Lpad, n_bank, B):
    ''' K1 on each shard of the MTBC bank split in two or three (common G
        and Qp, the whole bank's channel count) '''
    seqs = _bank_seqs('MTBC', nch)
    bank = parallel.ShardBank(seqs, Lpad, n_bank, 25)
    codes, rl = _k1_reads(B, Lpad, nch, seqs, nch + Lpad)
    c, r = torch.from_numpy(codes).to(cuda), torch.from_numpy(rl).to(cuda)
    for j in range(n_bank):
        state = bank.state(j, cuda)
        assert state.nch == nch and state.Qp == bank.Qp
        assert _screen_equal(c, r, state, nch, K1_PARAMS) > 0


def test_k1_many_launches_on_small_batches(cuda):
    ''' 240 launches in a row on batches of 1 to 300 reads, the two
        instantiations and two read paddings in turn (the layout's shared
        memory grows and shrinks; the attribute is set once per size):
        every count equals cand_counts_ref '''
    states = {}
    for nch in (4, 5):
        seqs = _bank_seqs('one tile' if nch == 4 else 'MTBC', nch)
        for Lpad in (64, 192):
            states[nch, Lpad] = seqs, tps.device_arrays(
                tts.build_bank(seqs, Lpad, 25), len(seqs), cuda)
    got, want = [], []
    before = tps.cand_counts.launches
    for i in range(240):
        nch, Lpad = (4, 5)[i % 2], (64, 192)[i // 2 % 2]
        seqs, state = states[nch, Lpad]
        codes, rl = _k1_reads(1 + i * 37 % 300, Lpad, nch, seqs, i)
        c, r = torch.from_numpy(codes).to(cuda), torch.from_numpy(rl).to(cuda)
        e, mo = K1_PARAMS[i % 4]
        got.append(tps.cand_counts(c, r, state, e, mo, nch))
        want.append(tps.cand_counts_ref(c, r, state, e, mo, nch))
    torch.cuda.synchronize()
    assert tps.cand_counts.launches == before + 240
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy(),
                                      err_msg='launch %d' % i)
    assert sum(int((w > 0).sum()) for w in want) > 0


def test_k1_never_waits_on_the_host(cuda):
    ''' under sync debug mode 'error' (any host read of a device value
        raises) K1 launches on a main-path batch and on a small one '''
    seqs = _bank_seqs('MTBC', 4)
    state = tps.device_arrays(tts.build_bank(seqs, 128, 25), len(seqs), cuda)
    batches = [tuple(torch.from_numpy(x).to(cuda) for x in
                     _k1_reads(B, 128, 4, seqs, B)) for B in (16384, 77)]
    tps.cand_counts(*batches[1], state, 2, 25, 4)     # the library's load
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        got = [tps.cand_counts(c, r, state, 2, 25, 4) for c, r in batches]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for (c, r), g in zip(batches, got):
        want = tps.cand_counts_ref(c, r, state, 2, 25, 4)
        np.testing.assert_array_equal(g.cpu().numpy(), want.cpu().numpy())
        assert (want > 0).any()


def test_cand_counts_on_a_device_that_is_not_current(cuda):
    ''' tensors on cuda:1 while cuda:0 is current launch on cuda:1 '''
    if torch.cuda.device_count() < 2:
        pytest.skip('needs two NVIDIA GPUs')
    dev1 = torch.device('cuda', 1)
    seqs, codes, rl, bank = case(11, 4, B=77, Lpad=64, nseq=9)
    state = tps.device_arrays(bank, len(seqs), dev1)
    c, r = torch.from_numpy(codes).to(dev1), torch.from_numpy(rl).to(dev1)
    with torch.cuda.device(0):
        got = tps.cand_counts(c, r, state, 2, 25, 4)
    torch.cuda.synchronize(dev1)
    want = tps.cand_counts_ref(torch.from_numpy(codes), torch.from_numpy(rl),
                               tps.device_arrays(bank, len(seqs), 'cpu'),
                               2, 25, 4)
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    assert (want > 0).any()


def test_score_rows_from_card_memory(cuda):
    ''' the scoring-pass bound follows the card's memory, not what the
        allocator holds at the moment '''
    rows = tts.score_rows(cuda, 40064)
    held = torch.empty(1 << 30, dtype=torch.uint8, device=cuda)
    assert tts.score_rows(cuda, 40064) == rows
    del held
    assert rows % 512 == 0 and rows * 40064 * tts.SCORE_BYTES_PER_ELEM \
        <= torch.cuda.get_device_properties(cuda).total_memory


def test_cand_counts_rejects_bad_input(cuda):
    seqs, codes, rl, bank = case(1, 4)
    state = tps.device_arrays(bank, len(seqs), cuda)
    c, r = torch.from_numpy(codes).to(cuda), torch.from_numpy(rl).to(cuda)
    for args in ((c.to(torch.int32), r), (c, r.long()), (c[:, :60], r),
                 (c.t().contiguous().t(), r), (c, r.cpu())):
        with pytest.raises(ValueError):
            tps.cand_counts(*args, state, 0, 25, 4)
    with pytest.raises(ValueError):
        tps.cand_counts(c, r, state, 0, 25, 5)


@pytest.mark.parametrize('gather_k', [0, 8, 1])
def test_scan_step_cuda_matches_cpu(cuda, gather_k):
    seqs, codes, rl, bank = case(42, 4, minoverlap=10)
    want = tps.scan_step_banked(
        torch.from_numpy(codes), torch.from_numpy(rl),
        tps.device_arrays(bank, len(seqs), 'cpu'), 1, 10, gather_k)
    got = tps.scan_step_banked(
        torch.from_numpy(codes).to(cuda), torch.from_numpy(rl).to(cuda),
        tps.device_arrays(bank, len(seqs), cuda), 1, 10, gather_k)
    for w, g in zip(want[:3], got[:3]):
        np.testing.assert_array_equal(w.numpy(), g.cpu().numpy())
    assert got[3].device.type == 'cuda' and got[3].dim() == 0
    assert int(want[3]) == int(got[3])


@pytest.mark.parametrize('rows', [None, 3])
def test_tensor_scanner_cuda_matches_cpu(cuda, rows, monkeypatch):
    ''' on the card a step is the whole batch (one K1 launch per batch),
        whatever the plain scoring's pass bound ``rows`` '''
    if rows:
        monkeypatch.setattr(tts, 'score_rows', lambda device, Qp: rows)
    seqs = ['CACCGGTGTAGGCAAGTCGTAACAAGG', 'TTTTTTTTTTGGGGGGGGGG', 'CCC']
    out = []
    for dev in ('cpu', cuda):
        sc = tts.TensorScanner(seqs, 1, 5, dev)
        sc.gather_k, sc._gather_auto = 4, False
        stats = reader.ReaderStats()
        before = tps.cand_counts.launches
        nbatches = 0
        for batch in reader.batches([FASTQ], ord('!'), 5, stats):
            sc.scan_batch(batch)
            nbatches += 1
        if dev == cuda:
            assert tps.cand_counts.launches - before == nbatches
        out.append((sc.coverages(), sc.seqhits, sc.seqbasehits))
    for w, g in zip(out[0][0], out[1][0]):
        np.testing.assert_array_equal(w, g)
    np.testing.assert_array_equal(out[0][1], out[1][1])
    np.testing.assert_array_equal(out[0][2], out[1][2])


_STATES = {}


def _state(cuda, bank, Lpad, nch):
    ''' the bank state of :py:func:`_bank_seqs` (built once per shape) '''
    key = (bank, Lpad, nch)
    if key not in _STATES:
        seqs = _bank_seqs(bank, nch)
        _STATES[key] = (seqs, tps.device_arrays(
            tts.build_bank(seqs, Lpad, 25), len(seqs), cuda))
    return _STATES[key]


def _score_equal(c, r, state, form, params=((2, 25), (3, 8))):
    ''' S1 equals score_candidates_ref exactly: ``dense`` scores every row;
        ``gathered`` the rows K1 flags, compacted (the ranks past the
        count hold real rows, which must not be read); ``above_gather_k``
        the scan step whose count is above its ``gather_k`` (a third of
        the candidates) scores them all.
        :returns: the hit weight of the first ``(e, mo)`` '''
    weight = None
    for e, mo in params:
        if form == 'dense':
            args = ()
        else:
            hit = tps.cand_counts(c, r, state, e, mo, state.nch) > 0
            idx, count = tps.compact(hit)
            n = int(count)
            idx[n:] = torch.arange(len(idx) - n, dtype=torch.int32,
                                   device=c.device)
            args = (idx, count)
        before = tps.score_candidates.launches
        if form == 'above_gather_k':
            k = max(1, n // 3)
            got = tps.scan_step_banked(c, r, state, e, mo, k)
            assert int(got[3]) == (n if k < len(c) else 0)   # else dense
            got = got[:3]
        else:
            got = tps.score_candidates(c, r, state, e, mo, *args)
        torch.cuda.synchronize()
        assert tps.score_candidates.launches == before + 1
        want = tps.score_candidates_ref(c, r, state, e, mo, *args,
                                        rows=4096)
        for name, w, g in zip(('basecount', 'seqhits', 'seqbasehits'),
                              want, got):
            assert g.dtype == torch.int64 and g.shape == w.shape
            np.testing.assert_array_equal(
                g.cpu().numpy(), w.cpu().numpy(),
                err_msg='%s e=%d mo=%d %s' % (name, e, mo, form))
        weight = int(want[1].sum()) if weight is None else weight
    return weight


@pytest.mark.parametrize('form', ['dense', 'gathered', 'above_gather_k'])
@pytest.mark.parametrize('bank', ['one tile', 'MTBC'])
@pytest.mark.parametrize('nch', [4, 5])
@pytest.mark.parametrize('Lpad', [36, 64, 128, 192])
@pytest.mark.parametrize('B', [1, 577, 16384])
def test_score_kernel_equals_ref(cuda, B, Lpad, nch, bank, form):
    ''' S1 at every read padding the reader makes (and 36), both channel
        counts, a one-tile and the whole MTBC bank, one read to a
        main-path batch, dense, gathered and above the step's gather_k '''
    seqs, state = _state(cuda, bank, Lpad, nch)
    assert state.nch == nch
    rng = np.random.RandomState(B + Lpad + nch)
    codes, rl = _planted_reads(rng, seqs, B, Lpad, nch)
    weight = _score_equal(torch.from_numpy(codes).to(cuda),
                          torch.from_numpy(rl).to(cuda), state, form)
    assert weight > 0 or B == 1


@pytest.mark.parametrize('form', ['dense', 'gathered', 'above_gather_k'])
@pytest.mark.parametrize('nch', [4, 5])
def test_score_kernel_on_bank_shards(cuda, nch, form):
    ''' S1 on each shard of the MTBC bank split in two '''
    seqs = _bank_seqs('MTBC', nch)
    bank = parallel.ShardBank(seqs, 128, 2, 25)
    rng = np.random.RandomState(10 + nch)
    codes, rl = _planted_reads(rng, seqs, 577, 128, nch)
    c, r = torch.from_numpy(codes).to(cuda), torch.from_numpy(rl).to(cuda)
    for j in range(2):
        assert _score_equal(c, r, bank.state(j, cuda), form) > 0


@pytest.mark.parametrize('nch', [4, 5])
@pytest.mark.parametrize('n', [0, 1, 127, 128, 129, 535, 'B'])
def test_score_kernel_at_counts(cuda, nch, n):
    ''' S1 over idx[:count], count read on the card, at counts on and
        around the edges of its row tiles (128 reads): every rank below
        the count scored once, none past it (they hold real rows) '''
    seqs, state = _state(cuda, 'MTBC', 128, nch)
    rng = np.random.RandomState(90 + nch)
    B = 1536
    codes, rl = _planted_reads(rng, seqs, B, 128, nch)
    n = B if n == 'B' else n
    c, r = torch.from_numpy(codes).to(cuda), torch.from_numpy(rl).to(cuda)
    idx = torch.from_numpy(rng.permutation(B).astype(np.int32)).to(cuda)
    count = torch.tensor(n, dtype=torch.int32, device=cuda)
    for e, mo in ((2, 25), (3, 8)):
        got = tps.score_candidates(c, r, state, e, mo, idx, count)
        want = tps.score_candidates_ref(c, r, state, e, mo, idx, count)
        for name, w, g in zip(('basecount', 'seqhits', 'seqbasehits'),
                              want, got):
            np.testing.assert_array_equal(
                g.cpu().numpy(), w.cpu().numpy(),
                err_msg='%s n=%d e=%d' % (name, n, e))
        assert int(want[1].sum()) > 0 if n >= 128 else n > 0 or \
            int(want[1].sum()) == 0


@pytest.mark.parametrize('nch', [4, 5])
@pytest.mark.parametrize('Lpad', [64, 128, 192])
def test_score_kernel_deep_locus(cuda, nch, Lpad):
    ''' every row the same planted read, so that one locus takes all the
        coverage: the drain's histogram on a deep locus, dense and
        gathered '''
    seqs, state = _state(cuda, 'MTBC', Lpad, nch)
    piece = max(seqs, key=len)[:Lpad - 8].encode()
    raw = np.full((1, Lpad), ord('A'), dtype=np.uint8)
    raw[0, 4:4 + len(piece)] = np.frombuffer(piece, np.uint8)
    codes = encode.encode_read_array(raw)
    codes[0, 4 + len(piece):] = encode.CODE_READ_JUNK
    codes = np.repeat(codes, 4096, 0)
    rl = np.full(4096, 4 + len(piece), dtype=np.int32)
    c, r = torch.from_numpy(codes).to(cuda), torch.from_numpy(rl).to(cuda)
    for form in ('dense', 'gathered'):
        assert _score_equal(c, r, state, form) >= 4096


@pytest.mark.parametrize('nch', [4, 5])
def test_score_kernel_long_reads(cuda, nch):
    ''' reads padded to 1,024: the depth takes several chunks of the A
        tile, and the stage's coverage histogram does not fit beside it, so
        the drain adds into basecount directly; dense and gathered '''
    seqs, state = _state(cuda, 'one tile', 1024, nch)
    rng = np.random.RandomState(1024 + nch)
    codes, rl = _planted_reads(rng, seqs, 300, 1024, nch)
    c, r = torch.from_numpy(codes).to(cuda), torch.from_numpy(rl).to(cuda)
    for form in ('dense', 'gathered'):
        assert _score_equal(c, r, state, form, ((2, 10), (3, 8))) > 0


def test_score_candidates_rejects_bad_input(cuda):
    seqs, codes, rl, bank = case(1, 4)
    state = tps.device_arrays(bank, len(seqs), cuda)
    c, r = torch.from_numpy(codes).to(cuda), torch.from_numpy(rl).to(cuda)
    idx, count = tps.compact(tps.cand_counts(c, r, state, 0, 25, 4) > 0)
    for args in ((c.to(torch.int32), r), (c, r.long()), (c[:, :60], r),
                 (c.t().contiguous().t(), r), (c, r.cpu()),
                 (c, r, idx, count.cpu()), (c, r, idx.cpu(), count),
                 (c, r, idx.long(), count)):
        with pytest.raises(ValueError):
            tps.score_candidates(args[0], args[1], state, 0, 25, *args[2:])


def test_scan_step_never_waits_on_the_host(cuda):
    ''' under sync debug mode 'error' (any host read of a device value
        raises): dense, gathered and above-gather_k steps, then 8 scanner
        steps; the flush, outside it, equals the CPU scanner '''
    seqs, codes, rl, bank = case(42, 4, B=96, minoverlap=10)
    state = tps.device_arrays(bank, len(seqs), cuda)
    c, r = torch.from_numpy(codes).to(cuda), torch.from_numpy(rl).to(cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        steps = [tps.scan_step_banked(c, r, state, 1, 10, k)
                 for k in (0, 64, 2)]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    cpu = tps.device_arrays(bank, len(seqs), 'cpu')
    for k, got in zip((0, 64, 2), steps):
        want = tps.scan_step_banked(torch.from_numpy(codes),
                                    torch.from_numpy(rl), cpu, 1, 10, k)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(w.numpy(), g.cpu().numpy())
    assert 2 < int(steps[2][3]) <= 64

    batches = [reader.RecordBatch(codes[k::8], rl[k::8], None, None)
               for k in range(8)]
    out = []
    for dev in (cuda, 'cpu'):
        sc = tts.TensorScanner(seqs, 1, 10, dev)
        sc.gather_k, sc._gather_auto = 4, False
        sc._context(codes.shape[1])      # the bank's upload may wait
        if dev == cuda:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode('error')
        try:
            for batch in batches:
                sc.scan_batch(batch)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        out.append((sc.coverages(), sc.seqhits, sc.seqbasehits))
    for w, g in zip(out[1][0], out[0][0]):
        np.testing.assert_array_equal(w, g)
    np.testing.assert_array_equal(out[0][1], out[1][1])
    np.testing.assert_array_equal(out[0][2], out[1][2])
    assert out[0][1].sum() > 0


def _sorted(tri):
    return tri[np.lexsort(tri.T[::-1])]


@pytest.mark.parametrize('nch', [4, 5])
@pytest.mark.parametrize('Lpad', [64, 192])
def test_screening_matcher_cuda_matches_cpu(cuda, nch, Lpad):
    ''' one K1 and one H1 launch per batch, compaction on the card, the
        same triplets as the plain screen on the CPU '''
    seqs, codes, rl, _ = case(70 + Lpad, nch, B=96, Lpad=Lpad, nseq=9)
    batch = reader.RecordBatch(codes, rl, np.zeros(len(codes), np.int64),
                               None)
    for e, mo in ((2, 25), (3, 8)):
        want = match_pallas.PallasMatcher(seqs, e, mo, 'cpu') \
            .match_batch(batch)
        before = tps.cand_counts.launches, tps.hit_triplets.launches
        got = match_pallas.PallasMatcher(seqs, e, mo, cuda).match_batch(batch)
        assert (tps.cand_counts.launches, tps.hit_triplets.launches) \
            == (before[0] + 1, before[1] + 1)
        np.testing.assert_array_equal(_sorted(got), _sorted(want))
        assert len(want) > 0


@pytest.mark.parametrize('params', [
    dict(maxerrors=0, minoverlap=1000, minreadlength=3),
    dict(maxerrors=1, minoverlap=10, minreadlength=5)])
def test_findseqs_cuda_matches_cpu(cuda, params):
    ''' the hit list on the card (through K1 and H1) equals the CPU's '''
    out = []
    try:
        for dev in ('cpu', cuda):
            tengine.config(device=str(dev), Amin='!', nthreads=1, **params)
            before = tps.cand_counts.launches, tps.hit_triplets.launches
            out.append(tengine.findseqs(FASTQ, SEQS7))
            if dev == cuda:
                assert tps.cand_counts.launches > before[0]
                assert tps.hit_triplets.launches > before[1]
    finally:
        tengine.config(device='cuda')
    assert out[0] == out[1]
    assert len(out[0]['hits']) > 0
    if params['minoverlap'] == 1000:
        assert list(np.bincount([h.seq_nr for h in out[1]['hits']],
                                minlength=7)) == [19, 1, 0, 1, 1, 1, 1]


def _cards(cuda, cards, n):
    ''' ``n`` mesh entries: the one card repeated, or every card in turn '''
    if cards == 'one card':
        return [cuda] * n
    count = torch.cuda.device_count()
    if count < 2:
        pytest.skip('needs two NVIDIA GPUs')
    return [torch.device('cuda', k % count) for k in range(n)]


@pytest.mark.parametrize('cards', ['one card', 'every card'])
@pytest.mark.parametrize('dense', [False, True], ids=['gathered', 'dense'])
def test_sharded_scanner_cuda_matches_tensor_scanner(cuda, dense, cards):
    ''' a 2x2 mesh (on one card, or over every card) equals the
        single-device TensorScanner; gathered, K1 runs on every entry of
        every step, dense never '''
    seqs = ['CACCGGTGTAGGCAAGTCGTAACAAGG', 'TTTTTTTTTTGGGGGGGGGG', 'CCC',
            'CCTTGTTACGACTTGCCTACACCGGTG', 'CCCCCCCCCCAAAAAAAAAA']
    scanners = [tts.TensorScanner(seqs, 1, 5, cuda),
                parallel.ShardedScanner(seqs, 1, 5, parallel.make_mesh(
                    2, 2, _cards(cuda, cards, 4)))]
    sharded = scanners[1]
    sharded.B_LOCAL, sharded.GATHER_K = 8, 2
    if dense:
        sharded.assume_dense()
    out = []
    for sc in scanners:
        before = tps.cand_counts.launches
        stats = reader.ReaderStats()
        for batch in reader.batches([FASTQ], ord('!'), 5, stats,
                                    batchsize=32):
            sc.scan_batch(batch)
        out.append((sc.coverages(), sc.seqhits, sc.seqbasehits))
    launched = tps.cand_counts.launches - before
    if dense:
        assert launched == 0
    else:
        assert launched == sharded.launches.sum() > 0
        assert (sharded.launches == sharded.launches[0, 0]).all()
    for w, g in zip(out[0][0], out[1][0]):
        np.testing.assert_array_equal(w, g)
    np.testing.assert_array_equal(out[0][1], out[1][1])
    np.testing.assert_array_equal(out[0][2], out[1][2])
    assert out[0][1].sum() > 0


@pytest.mark.parametrize('cards', ['one card', 'every card'])
@pytest.mark.parametrize('nch', [4, 5])
def test_sharded_matcher_cuda_matches_pallas_matcher(cuda, nch, cards):
    ''' the mesh hit path (1x2 and 2x2, on one card or over every card)
        gives the screening matcher's triplets, one K1 launch per entry
        and chunk '''
    seqs, codes, rl, _ = case(90 + nch, nch, B=96, Lpad=64, nseq=9)
    batch = reader.RecordBatch(codes, rl, np.zeros(len(codes), np.int64),
                               None)
    want = match_pallas.PallasMatcher(seqs, 2, 25, cuda).match_batch(batch)
    assert len(want) > 0
    for n_data, n_bank in ((1, 2), (2, 2)):
        matcher = parallel.ShardedMatcher(
            seqs, 2, 25, parallel.make_mesh(
                n_data, n_bank, _cards(cuda, cards, n_data * n_bank)),
            b_local=32)
        before = tps.cand_counts.launches
        got = matcher.match_batch(batch)
        chunks = -(-96 // (32 * n_data))
        assert tps.cand_counts.launches - before \
            == matcher.launches.sum() == chunks * n_data * n_bank
        assert (matcher.launches == chunks).all()
        np.testing.assert_array_equal(_sorted(got), _sorted(want))


def test_local_mesh_cuda(cuda):
    ''' a process alone takes every card of its host for its default mesh,
        all on the data axis '''
    from kvarq_tpu_torch.parallel import multihost
    mesh = multihost.local_mesh('cuda')
    count = torch.cuda.device_count()
    assert mesh.shape == {'data': count, 'bank': 1}
    assert [row[0] for row in mesh.devices] == [
        torch.device('cuda', k) for k in range(count)]


# --- H1, the exact hit extraction --------------------------------------------

def _tri_set(tri):
    ''' a triplet array in lexicographic order '''
    tri = np.asarray(tri, dtype=np.int64).reshape(-1, 3)
    return tri[np.lexsort(tri.T[::-1])]


def _hits_equal(c, r, state, form, params=((2, 25), (3, 8)), cap=1 << 16,
                row_ids=None):
    ''' H1 equals hit_triplets_ref exactly, as sorted triplet sets, at a
        capacity of at least ``cap`` that holds them all: ``dense`` over
        every row, ``gathered`` over the rows K1 flags, compacted (the ranks
        past the count hold real rows, which must not be read).
        :returns: the triplets of the first ``(e, mo)`` '''
    found = None
    for e, mo in params:
        if form == 'dense':
            args = ()
        else:
            hit = tps.cand_counts(c, r, state, e, mo, state.nch) > 0
            idx, count = tps.compact(hit)
            n = int(count)
            idx[n:] = torch.arange(len(idx) - n, dtype=torch.int32,
                                   device=c.device)
            args = (idx, count)
        want, wn = tps.triplets_to_host(*tps.hit_triplets_ref(
            c, r, state, e, mo, *args, row_ids=row_ids, cap=None, rows=4096))
        size = max(cap, wn)
        before = tps.hit_triplets.launches
        buf, n = tps.hit_triplets(c, r, state, e, mo, *args, row_ids=row_ids,
                                  cap=size)
        torch.cuda.synchronize()
        assert tps.hit_triplets.launches == before + 1
        assert buf.dtype == torch.int32 and buf.shape == (size, 3)
        assert n.device == c.device and n.dim() == 0
        got, count = tps.triplets_to_host(buf, n)
        assert count == wn
        np.testing.assert_array_equal(_tri_set(got), _tri_set(want),
                                      err_msg='e=%d mo=%d %s' % (e, mo, form))
        found = want if found is None else found
    return found


@pytest.mark.parametrize('form', ['dense', 'gathered'])
@pytest.mark.parametrize('bank', ['one tile', 'MTBC'])
@pytest.mark.parametrize('nch', [4, 5])
@pytest.mark.parametrize('Lpad', [64, 128, 192])
@pytest.mark.parametrize('B', [1, 577, 16384])
def test_hit_kernel_equals_ref(cuda, B, Lpad, nch, bank, form):
    ''' H1 at the reader's read paddings, both channel counts, a one-tile
        and the whole MTBC bank, one read to a main-path batch, dense and
        gathered '''
    seqs, state = _state(cuda, bank, Lpad, nch)
    rng = np.random.RandomState(B + Lpad + nch + 7)
    codes, rl = _planted_reads(rng, seqs, B, Lpad, nch)
    tri = _hits_equal(torch.from_numpy(codes).to(cuda),
                      torch.from_numpy(rl).to(cuda), state, form)
    assert len(tri) > 0 or B == 1


@pytest.mark.parametrize('nch', [4, 5])
def test_hit_kernel_on_bank_shards(cuda, nch):
    ''' H1 on each shard of the MTBC bank split in two: template ids are
        global '''
    seqs = _bank_seqs('MTBC', nch)
    bank = parallel.ShardBank(seqs, 128, 2, 25)
    rng = np.random.RandomState(20 + nch)
    codes, rl = _planted_reads(rng, seqs, 577, 128, nch)
    c, r = torch.from_numpy(codes).to(cuda), torch.from_numpy(rl).to(cuda)
    for j in range(2):
        for form in ('dense', 'gathered'):
            tri = _hits_equal(c, r, bank.state(j, cuda), form)
            assert len(tri) > 0
            lo_, hi = bank.ranges[j]
            assert ((tri[:, 1] >= lo_) & (tri[:, 1] < hi)).all()


@pytest.mark.parametrize('nch', [4, 5])
@pytest.mark.parametrize('n', [0, 1, 127, 128, 129, 535, 'B', 'above'])
def test_hit_kernel_at_counts(cuda, nch, n):
    ''' H1 over idx[:count], count read on the card, at counts 0 to B and
        above len(idx) (clamped): every rank below the count once, none
        past it; a row map applied to the batch rows; read back by
        ``read_triplets`` (a rerun where the first capacity overflows) '''
    seqs, state = _state(cuda, 'MTBC', 128, nch)
    rng = np.random.RandomState(95 + nch)
    B = 1536
    codes, rl = _planted_reads(rng, seqs, B, 128, nch)
    n = {'B': B, 'above': B + 77}.get(n, n)
    c, r = torch.from_numpy(codes).to(cuda), torch.from_numpy(rl).to(cuda)
    idx = torch.from_numpy(rng.permutation(B).astype(np.int32)).to(cuda)
    count = torch.tensor(n, dtype=torch.int32, device=cuda)
    ids = torch.from_numpy((rng.permutation(B) + 10 ** 6).astype(np.int32)) \
        .to(cuda)
    from kvarq_tpu_torch.engine import match_xla
    for e, mo in ((2, 25), (3, 8)):
        for row_ids in (None, ids):
            got, _ = match_xla.read_triplets(c, r, state, e, mo, idx, count,
                                             row_ids, cap=1 << 12)
            want = tps.triplets_to_host(*tps.hit_triplets_ref(
                c, r, state, e, mo, idx, count, row_ids, cap=None))
            assert len(got) == want[1]
            np.testing.assert_array_equal(_tri_set(got), _tri_set(want[0]))
            if n >= 128:
                assert want[1] > 0
            elif n == 0:
                assert want[1] == 0


@pytest.mark.parametrize('nch', [4, 5])
@pytest.mark.parametrize('Lpad', [64, 128, 192])
def test_hit_kernel_deep_locus_overflows(cuda, nch, Lpad):
    ''' every row the same planted read: the triplets of one locus overflow
        a small capacity.  The counter still ends at the true number, the
        slots written are triplets of the set, and the matcher's rerun at
        the next power of two gives the whole set and keeps the capacity '''
    from kvarq_tpu_torch.engine import match_xla
    seqs, state = _state(cuda, 'MTBC', Lpad, nch)
    piece = max(seqs, key=len)[:Lpad - 8].encode()
    raw = np.full((1, Lpad), ord('A'), dtype=np.uint8)
    raw[0, 4:4 + len(piece)] = np.frombuffer(piece, np.uint8)
    codes = encode.encode_read_array(raw)
    codes[0, 4 + len(piece):] = encode.CODE_READ_JUNK
    codes = np.repeat(codes, 4096, 0)
    rl = np.full(4096, 4 + len(piece), dtype=np.int32)
    c, r = torch.from_numpy(codes).to(cuda), torch.from_numpy(rl).to(cuda)
    want = _tri_set(_hits_equal(c, r, state, 'dense', ((2, 25),)))
    assert len(want) >= 4096
    got, n = tps.triplets_to_host(*tps.hit_triplets(c, r, state, 2, 25,
                                                    cap=100))
    assert n == len(want) and len(got) == 100
    assert len(np.unique(got, axis=0)) == 100
    assert {tuple(t) for t in got} <= {tuple(t) for t in want}
    matcher = match_xla.XlaMatcher(seqs, 2, 25, cuda)
    matcher.cap = 100
    for form in ('dense', 'gathered'):
        args = () if form == 'dense' else tps.compact(tps.cand_counts(
            c, r, state, 2, 25, state.nch) > 0)
        np.testing.assert_array_equal(
            _tri_set(matcher.extract(c, r, *args)), want)
        assert matcher.cap == 1 << (len(want) - 1).bit_length()


@pytest.mark.parametrize('nch', [4, 5])
def test_hit_kernel_long_reads(cuda, nch):
    ''' reads padded to 1,024: the depth takes several chunks of the A
        tile; dense and gathered '''
    seqs, state = _state(cuda, 'one tile', 1024, nch)
    rng = np.random.RandomState(2048 + nch)
    codes, rl = _planted_reads(rng, seqs, 300, 1024, nch)
    c, r = torch.from_numpy(codes).to(cuda), torch.from_numpy(rl).to(cuda)
    for form in ('dense', 'gathered'):
        assert len(_hits_equal(c, r, state, form, ((2, 10), (3, 8)))) > 0


def test_hit_triplets_rejects_bad_input(cuda):
    seqs, codes, rl, bank = case(3, 4)
    state = tps.device_arrays(bank, len(seqs), cuda)
    c, r = torch.from_numpy(codes).to(cuda), torch.from_numpy(rl).to(cuda)
    idx, count = tps.compact(tps.cand_counts(c, r, state, 0, 25, 4) > 0)
    ids = torch.arange(len(c), dtype=torch.int32, device=cuda)
    for args, kw in (((c.to(torch.int32), r), {}), ((c, r.long()), {}),
                     ((c, r, idx, count.cpu()), {}),
                     ((c, r, idx.long(), count), {}),
                     ((c, r), dict(row_ids=ids.long())),
                     ((c, r), dict(row_ids=ids.cpu())),
                     ((c, r), dict(row_ids=ids[:-1])),
                     ((c, r), dict(cap=-1)), ((c, r), dict(cap=None))):
        with pytest.raises(ValueError):
            tps.hit_triplets(args[0], args[1], state, 0, 25, *args[2:], **kw)


def _host_waits(fn):
    ''' ``(fn(), waits)``: the synchronizing CUDA operations fn made, as
        ``torch.cuda.set_sync_debug_mode('warn')`` reports them '''
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter('always')
        torch.cuda.set_sync_debug_mode('warn')
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, [str(w.message) for w in seen
                 if 'called a synchronizing CUDA operation' in str(w.message)]


@pytest.mark.parametrize('mesh', [None, (1, 2), (2, 2)])
def test_hit_matchers_wait_on_the_host_once(cuda, mesh):
    ''' the screening matcher, and the sharded one on a mesh that repeats
        the card, wait on the host once per batch (the readback of the
        triplets and their count) and call no torch.nonzero; the same
        triplets as the CPU's '''
    seqs, codes, rl, _ = case(77, 4, B=96, Lpad=64, nseq=9)
    batch = reader.RecordBatch(codes, rl, np.zeros(len(codes), np.int64),
                               None)
    if mesh is None:
        matcher = match_pallas.PallasMatcher(seqs, 2, 25, cuda)
    else:
        matcher = parallel.ShardedMatcher(
            seqs, 2, 25, parallel.make_mesh(*mesh, [cuda] * 4), b_local=48)
    want = match_pallas.PallasMatcher(seqs, 2, 25, 'cpu').match_batch(batch)
    assert len(want) > 0
    matcher.match_batch(batch)           # bank states, uploads, the build
    nonzero = torch.nonzero

    def no_nonzero(*a, **kw):
        raise AssertionError('torch.nonzero on the hit path')
    torch.nonzero = no_nonzero
    try:
        before = tps.hit_triplets.launches
        got, waits = _host_waits(lambda: matcher.match_batch(batch))
    finally:
        torch.nonzero = nonzero
    assert tps.hit_triplets.launches == before + 1
    assert len(waits) == 1, waits
    np.testing.assert_array_equal(_tri_set(got), _tri_set(want))
