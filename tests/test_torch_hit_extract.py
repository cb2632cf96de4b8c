'''
The exact hit extraction of kvarq_tpu_torch (the plain version of the
kernel H1, ``pallas_scan.hit_triplets_ref``, which ``hit_triplets`` runs on
a CPU tensor) against kvarq_tpu on the CPU: against ``XlaMatcher`` over
every row and against ``PallasMatcher`` in interpret mode over the rows
the screen flags, compacted; the H1 contract (``idx``/``count`` on the
device, the row map, the capacity and the rerun after an overflow); and
the matchers built on it (the screening matcher's compaction path, the
sharded matcher on a ``cpu`` mesh) against kvarq_tpu's matchers.  Every
comparison is exact equality of the sorted triplets.
'''

import numpy as np
import pytest
import torch

from kvarq_tpu.engine.match_pallas import PallasMatcher as JaxPallasMatcher
from kvarq_tpu.engine.match_xla import XlaMatcher as JaxXlaMatcher
from kvarq_tpu_torch import parallel
from kvarq_tpu_torch.engine import match_pallas, match_xla
from kvarq_tpu_torch.engine import pallas_scan as tps

from _torch_cases import case
from test_torch_hits import _batch, _planted_case, _sorted


def _ref(codes, rl, state, e, mo, *args, **kw):
    ''' hit_triplets_ref's triplets and count, from the host '''
    return tps.triplets_to_host(*tps.hit_triplets_ref(
        torch.from_numpy(codes), torch.from_numpy(rl), state, e, mo, *args,
        **kw))


def _state(seqs, bank):
    return tps.device_arrays(bank, len(seqs), 'cpu')


def _screened(codes, rl, state, e, mo):
    ''' ``(idx, count)``: the rows the plain screen flags, compacted '''
    return tps.compact(tps.cand_counts_ref(
        torch.from_numpy(codes), torch.from_numpy(rl), state, e, mo,
        state.nch) > 0)


@pytest.mark.parametrize('Lpad', [64, 192])
@pytest.mark.parametrize('minoverlap', [8, 25])
@pytest.mark.parametrize('maxerrors', [0, 3])
@pytest.mark.parametrize('nch', [4, 5])
@pytest.mark.parametrize('against', ['xla', 'pallas'])
def test_hit_triplets_ref_matches_kvarq_tpu(against, nch, maxerrors,
                                            minoverlap, Lpad):
    ''' over every row, kvarq_tpu's XlaMatcher triplets; over the screened
        rows, compacted (count read from the device tensor), its
        PallasMatcher's (Pallas in interpret mode); the count equals the
        triplets and the buffer holds them all at the default capacity '''
    B = 24
    seqs, codes, rl, bank = _planted_case(
        300 + Lpad + 10 * maxerrors + minoverlap, nch, B, Lpad, minoverlap)
    state = _state(seqs, bank)
    if against == 'xla':
        want = JaxXlaMatcher(seqs, maxerrors, minoverlap).match_batch(
            _batch(codes, rl))
        got, n = _ref(codes, rl, state, maxerrors, minoverlap)
    else:
        want = JaxPallasMatcher(seqs, maxerrors, minoverlap, sub=B, TB=8,
                                TQ=128).match_batch(_batch(codes, rl))
        idx, count = _screened(codes, rl, state, maxerrors, minoverlap)
        got, n = _ref(codes, rl, state, maxerrors, minoverlap, idx, count)
    assert len(want) > 0
    assert n == len(got) == len(want)
    np.testing.assert_array_equal(_sorted(got), _sorted(want))


def _contract_case():
    seqs, codes, rl, bank = _planted_case(71, 4, 40, 64, 10)
    state = _state(seqs, bank)
    return codes, rl, state, _ref(codes, rl, state, 2, 10)[0]


@pytest.mark.parametrize('n', [0, 7, 'len', 'above'])
def test_hit_triplets_ref_over_idx_count(n):
    ''' ``idx[:count]`` with the count a device tensor: 0 rows, a prefix,
        all of idx, and a count above ``len(idx)`` (clamped); the triplets
        report batch rows '''
    codes, rl, state, dense = _contract_case()
    rng = np.random.RandomState(3)
    idx = torch.from_numpy(rng.permutation(len(codes))[:30].astype(np.int32))
    n = {'len': len(idx), 'above': len(idx) + 5}.get(n, n)
    count = torch.tensor(n, dtype=torch.int32)
    got, cnt = _ref(codes, rl, state, 2, 10, idx, count)
    rows = set(idx[:n].tolist())
    want = dense[[b in rows for b in dense[:, 0]]]
    assert cnt == len(want) == len(got)
    np.testing.assert_array_equal(_sorted(got), _sorted(want))
    if n:
        assert len(want) > 0


def test_hit_triplets_ref_row_ids():
    ''' a row map reports ``row_ids[b]`` for batch row ``b``, dense and
        over idx '''
    codes, rl, state, dense = _contract_case()
    ids = np.arange(len(codes), dtype=np.int32)[::-1] * 3 + 1000
    want = dense.copy()
    want[:, 0] = ids[dense[:, 0]]
    got, _ = _ref(codes, rl, state, 2, 10, row_ids=torch.from_numpy(ids))
    np.testing.assert_array_equal(_sorted(got), _sorted(want))
    idx = torch.arange(len(codes), dtype=torch.int32)
    got, _ = _ref(codes, rl, state, 2, 10, idx, row_ids=torch.from_numpy(ids))
    np.testing.assert_array_equal(_sorted(got), _sorted(want))


def test_hit_triplets_overflow_rerun():
    ''' capacity 1: the count is still the number of triplets and the one
        slot holds one of them; ``read_triplets`` scores again at the next
        power of two and returns the whole set, and a matcher keeps the
        grown capacity '''
    codes, rl, state, dense = _contract_case()
    assert len(dense) > 2
    (got, n), (want, _) = (_ref(codes, rl, state, 2, 10, cap=1),
                           _ref(codes, rl, state, 2, 10, cap=None))
    assert n == len(dense) and len(got) == 1
    assert tuple(got[0]) in {tuple(t) for t in dense}
    c, r = torch.from_numpy(codes), torch.from_numpy(rl)
    tri, cap = match_xla.read_triplets(c, r, state, 2, 10, cap=1)
    assert cap == 1 << (len(dense) - 1).bit_length() and cap >= len(dense)
    np.testing.assert_array_equal(_sorted(tri), _sorted(dense))
    tri, same = match_xla.read_triplets(c, r, state, 2, 10, cap=cap)
    assert same == cap
    np.testing.assert_array_equal(_sorted(tri), _sorted(want))


def test_hit_triplets_on_cpu_is_the_plain_version():
    ''' on a CPU tensor the wrapper is its plain version: no launch '''
    codes, rl, state, dense = _contract_case()
    before = tps.hit_triplets.launches
    got, n = tps.triplets_to_host(*tps.hit_triplets(
        torch.from_numpy(codes), torch.from_numpy(rl), state, 2, 10))
    assert tps.hit_triplets.launches == before
    assert n == len(dense)
    np.testing.assert_array_equal(_sorted(got), _sorted(dense))


def test_hit_triplets_rejects_bad_input():
    codes, rl, state, _ = _contract_case()
    c, r = torch.from_numpy(codes), torch.from_numpy(rl)
    ids = torch.arange(len(c), dtype=torch.int32)
    for kw in (dict(row_ids=ids.long()), dict(row_ids=ids[:-1]),
               dict(cap=-1), dict(idx=ids.long())):
        with pytest.raises(ValueError):
            tps.hit_triplets(c, r, state, 2, 10, **kw)


@pytest.mark.parametrize('nch', [4, 5])
def test_screening_matcher_compaction_path(nch, monkeypatch):
    ''' K1's plain screen, ``compact`` (no torch.nonzero on the matcher's
        own path) and the extraction over ``idx[:count]`` give kvarq_tpu's
        PallasMatcher triplets, batch rows included '''
    seqs, codes, rl, _ = case(31 + nch, nch, B=32, Lpad=64, nseq=5,
                              minoverlap=20)
    want = JaxPallasMatcher(seqs, 2, 20, sub=32, TB=8, TQ=128).match_batch(
        _batch(codes, rl))
    assert len(want) > 0
    compacted = []

    def counted(mask, size=None):
        out = compact(mask, size)
        compacted.append(int(out[1]))
        return out
    compact = tps.compact
    monkeypatch.setattr(tps, 'compact', counted)
    got = match_pallas.PallasMatcher(seqs, 2, 20, 'cpu').match_batch(
        _batch(codes, rl))
    assert len(compacted) == 1 and 0 < compacted[0] < 32
    np.testing.assert_array_equal(_sorted(got), _sorted(want))


@pytest.mark.parametrize('shape', [(1, 2), (2, 2)])
@pytest.mark.parametrize('nch', [4, 5])
def test_sharded_matcher_on_cpu_mesh(nch, shape):
    ''' the sharded matcher on a ``cpu`` mesh (flags merged and compacted
        on the first entry, the extraction there) gives kvarq_tpu's
        XlaMatcher and PallasMatcher triplets '''
    seqs, codes, rl, _ = case(41 + nch, nch, B=48, Lpad=64, nseq=9)
    want = JaxXlaMatcher(seqs, 2, 25).match_batch(_batch(codes, rl))
    assert len(want) > 0
    np.testing.assert_array_equal(
        _sorted(JaxPallasMatcher(seqs, 2, 25, sub=48, TB=8, TQ=128)
                .match_batch(_batch(codes, rl))), _sorted(want))
    matcher = parallel.ShardedMatcher(
        seqs, 2, 25, parallel.make_mesh(*shape, ['cpu'] * 4), b_local=16)
    got = matcher.match_batch(_batch(codes, rl))
    np.testing.assert_array_equal(_sorted(got), _sorted(want))
