'''
H1's arithmetic on the CPU: the triplets of the hit drain of
csrc/kvq_s1_pipeline.h (``Consumer::hits``) computed in plain torch the
way the kernel computes them -- the match counts of its staged operands
(the rows' one-hot tile against the window rows of ``BankState.onehot``) in
``s1_columns`` order, the last group's padding columns included; K1's
screen on the clamped 16-bit halves of ``BankState.sterms``, each pair's
pass bit kept; in each passing pair the hit modes in integers from the
read's length and the column's d, seql and valid (the screen is
``mode_weights``' test of the count, asserted here); the pairs with a
weight above 0 as ``(row id, template, d)`` -- equal
``hit_triplets_ref`` and kvarq_tpu's extraction (``XlaMatcher`` on JAX's
CPU) as sorted triplet sets, and every passing pair's count equals the
per-pair recount of S1's drain (the read's codes against the staged
window, position by position), which H1 no longer makes.  Every quantity is an
integer: the comparisons are exact equality.
'''

import numpy as np
import pytest
import torch

from kvarq_tpu.engine import encode
from kvarq_tpu.engine.match_xla import XlaMatcher as JaxXlaMatcher
from kvarq_tpu_torch.engine import pallas_scan as tps
from kvarq_tpu_torch.engine.tensor_scan import build_bank

from _torch_cases import periodic_case
from test_torch_cand_terms import (_reads, column_halves, pass_bits,
                                   staged_counts)
from test_torch_hits import _batch, _sorted

# rows of a row tile, and its layout over the consumer warpgroups: row
# 64 wg + 16 (warp % 4) + 8 h + g of the tile, MMA column 8 j + 2 t + e of
# the stage in lane 4 g + t (kvq_onehot_mma.h, acc_read)
TB = 128


def mode_bits(rl, d, seql, minoverlap):
    ''' ``(w, ov)``: the kernel's mode_bits in integers, the hit modes of a
        read at a column (tensor_scan.mode_weights without its pass
        test), and the overlap '''
    t1 = d + rl
    ov = torch.minimum(seql, t1) - torch.clamp(d, min=0)
    ab = (rl > minoverlap) & (seql > minoverlap)
    govmo = ov >= minoverlap
    wA = ab & (d < 0) & govmo & (ov != seql)
    wB = ab & (d > 0) & govmo & (t1 >= seql)
    full = ov == torch.minimum(rl, seql)
    return wA.long() + wB.long() + full.long(), ov


def h1_pairs(codes, rl, state, maxerrors, minoverlap, sel):
    ''' H1's drain over the batch rows ``sel`` (one per rank), in plain
        torch: ``(m, q, passing, w)``, the counts, shift columns, pass bits
        and weights of every ``[rank, column]`` pair in ``s1_columns``
        order.  The pass bits are K1's screen's (``pass_bits``, which
        asserts that its 16-bit halves hold every intermediate), the
        weights those of the kernel: a passing pair's hit modes where its
        column is valid and its read not empty.  Asserts that the pass
        bits equal the screen's compare, ``count + e >= max(min(rl + dm,
        ovc), min(rlmo, seql))`` with the clamped terms; that no padding
        column passes; and that the weights equal ``mode_weights`` of the
        count (so the screen tests ``ov - count <= e`` where the column is
        valid, and a pair it rejects weighs nothing). '''
    m, q = staged_counts(codes[sel], state)
    r = rl[sel].long()[:, None]
    passing = pass_bits(m, rl[sel], state, maxerrors, minoverlap) == 1
    col = column_halves(state)
    clamp = tps.S1_TERM_CLAMP
    rlv = torch.clamp(r, max=clamp)
    rlmo = torch.clamp(torch.where(rlv > 0, torch.clamp(rlv, max=minoverlap),
                                   tps.BIG_RL_THRESHOLD), max=clamp)
    dm, ovc, sq = -col[:, 0], -col[:, 1], -col[:, 2]
    exact = m + maxerrors >= torch.maximum(torch.minimum(rlv + dm, ovc),
                                           torch.minimum(rlmo, sq))
    assert torch.equal(passing, exact)
    assert not passing[:, q >= state.Qp].any()
    qm = state.qmeta.long()[:, q.clamp(max=state.Qp - 1)]
    d, seql = qm[tps.ROW_D], qm[tps.ROW_SEQL]
    valid = torch.where(q < state.Qp, qm[tps.ROW_VALID], 0)
    bits, ov = mode_bits(r, d, seql, minoverlap)
    w = torch.where(passing & (valid > 0) & (r > 0), bits, 0)
    counted = (valid > 0) & (r > 0) & (ov - m <= maxerrors)
    np.testing.assert_array_equal(w.numpy(),
                                  torch.where(counted, bits, 0).numpy())
    return m, q, passing, w


def recount(codes, state, sel, q, pairs):
    ''' the count of each ``[rank, column]`` pair of ``pairs`` as S1's
        drain recounts it: every read position j < Lpad whose
        code c is below nch, against byte SP j + c of the column's window
        row in residue s's copy of the one-hot bank '''
    SP, _ = tps.s1_depth(state.Lpad, state.nch)
    R = 16 // SP
    cb = codes[sel][pairs[:, 0]].long()
    qq = q[pairs[:, 1]]
    s = qq % R
    j = torch.arange(state.Lpad)
    at = SP * (qq - s)[:, None] + SP * j + torch.clamp(cb, max=SP - 1)
    byte = state.onehot.long()[s[:, None], at]
    return ((byte != 0) & (cb < state.nch)).sum(dim=1)


def h1_triplets(codes, rl, state, maxerrors, minoverlap, sel, row_ids=None):
    ''' ``(triplets [n, 3], w)``: the twin's triplets over ``sel`` and its
        weights; asserts that the counts of the passing pairs equal their
        recount '''
    m, q, passing, w = h1_pairs(codes, rl, state, maxerrors, minoverlap, sel)
    pairs = passing.nonzero()
    np.testing.assert_array_equal(
        recount(codes, state, sel, q, pairs).numpy(),
        m[pairs[:, 0], pairs[:, 1]].numpy())
    rank, ci = (w > 0).nonzero(as_tuple=True)
    rows = sel[rank]
    qq = q[ci]
    tri = torch.stack([rows if row_ids is None else row_ids[rows].long(),
                       state.tseg.long()[qq],
                       state.qmeta.long()[tps.ROW_D, qq]], dim=1)
    return tri.numpy(), w


def full_warps(w):
    ''' the (stage, warp) pairs of the pipeline's schedule in which every
        lane holds a pair with w > 0, ``w`` ``[ranks, columns]`` '''
    ranks, ncol = w.shape
    hit = torch.zeros(-(-ranks // TB) * TB, ncol, dtype=torch.bool)
    hit[:ranks] = w > 0
    # rows (tile, wg, warp % 4, h, g), columns (stage, j, t, e)
    hit = hit.reshape(-1, 2, 4, 2, 8, ncol // 128, 16, 4, 2)
    lane = hit.any(dim=8).any(dim=6).any(dim=3)   # (tile, wg, w4, g, S, t)
    return int(lane.all(dim=5).all(dim=3).sum())


def _xla(seqs, codes, rl, maxerrors, minoverlap, sel, row_ids=None):
    ''' kvarq_tpu's XlaMatcher triplets of the rows ``sel``, their rows
        mapped through ``row_ids`` '''
    tri = np.asarray(JaxXlaMatcher(seqs, maxerrors, minoverlap).match_batch(
        _batch(codes, rl)), dtype=np.int64).reshape(-1, 3)
    tri = tri[np.isin(tri[:, 0], sel.numpy())]
    if row_ids is not None:
        tri[:, 0] = row_ids.numpy()[tri[:, 0]]
    return tri


def _equal(seqs, codes, rl, state, maxerrors, minoverlap, idx=None,
           count=None, row_ids=None):
    ''' the twin's triplets equal hit_triplets_ref's and XlaMatcher's
        exactly; :returns: ``(triplets, w)`` '''
    c, r = torch.from_numpy(codes), torch.from_numpy(rl)
    sel = torch.arange(len(codes))
    if idx is not None:
        n = len(idx) if count is None else max(0, min(int(count), len(idx)))
        sel = idx[:n].long()
    got, w = h1_triplets(c, r, state, maxerrors, minoverlap, sel, row_ids)
    want, n = tps.triplets_to_host(*tps.hit_triplets_ref(
        c, r, state, maxerrors, minoverlap, idx, count, row_ids, cap=None))
    assert n == len(got) == len(want)
    np.testing.assert_array_equal(_sorted(got), _sorted(want))
    np.testing.assert_array_equal(
        _sorted(got), _sorted(_xla(seqs, codes, rl, maxerrors, minoverlap,
                                   sel, row_ids)))
    return got, w


def _hit_reads(seed, nch, B, Lpad):
    ''' the reads of test_torch_cand_terms (lengths 0 with bases kept,
        empty reads, a bank whose Qp is no multiple of the column group),
        a whole template planted in every third, so that hits occur at any
        maxerrors: also into reads of length 0, which pass the screen
        where their codes match a template whole '''
    seqs, codes, rl, bank = _reads(seed, nch, B, Lpad, 9)
    rng = np.random.RandomState(seed)
    for b in range(0, B, 3):
        t = encode.encode_template(seqs[rng.randint(len(seqs))])[:Lpad]
        off = rng.randint(0, Lpad - len(t) + 1)
        codes[b, off:off + len(t)] = t
        if rl[b]:
            rl[b] = max(rl[b], off + len(t))
            codes[b, rl[b]:] = encode.CODE_READ_JUNK
    return seqs, codes, rl, bank


MINOVERLAP = 25


@pytest.mark.parametrize('maxerrors', [0, 1, 2, 3])
@pytest.mark.parametrize('Lpad', [64, 128, 192])
@pytest.mark.parametrize('nch', [4, 5])
def test_h1_arithmetic_equals_ref_and_kvarq_tpu(nch, Lpad, maxerrors):
    ''' 130 reads (one row tile and two reads) against a bank whose Qp is
        no multiple of the 512-column group '''
    seqs, codes, rl, bank = _hit_reads(Lpad + nch, nch, 130, Lpad)
    state = tps.device_arrays(bank, len(seqs), 'cpu')
    assert state.nch == nch and state.Qp % tps.S1_GROUP
    got, w = _equal(seqs, codes, rl, state, maxerrors, MINOVERLAP)
    assert len(got) > 0
    # reads of length 0 whose bases match pass the screen, weigh nothing
    _, _, passing, _ = h1_pairs(torch.from_numpy(codes), torch.from_numpy(rl),
                                state, maxerrors, MINOVERLAP,
                                torch.arange(len(codes)))
    assert passing[torch.from_numpy(rl == 0)].any()


@pytest.mark.parametrize('form', ['idx', 'count', 'row_ids'])
@pytest.mark.parametrize('nch', [4, 5])
def test_h1_arithmetic_over_rows(nch, form):
    ''' the rows idx[:count] (idx a permutation; count past len(idx) is
        clamped), their triplets reporting row_ids[row] '''
    seqs, codes, rl, _ = _hit_reads(40 + nch, nch, 130, 128)
    rng = np.random.RandomState(7 + nch)
    idx = torch.from_numpy(rng.permutation(130).astype(np.int32))
    count = {'idx': None, 'count': torch.tensor(67, dtype=torch.int32),
             'row_ids': torch.tensor(200, dtype=torch.int32)}[form]
    ids = torch.from_numpy((rng.permutation(130) + 10 ** 6).astype(np.int32)) \
        if form == 'row_ids' else None
    for maxerrors, minoverlap in ((2, 25), (3, 8)):
        state = tps.device_arrays(build_bank(seqs, 128, minoverlap),
                                  len(seqs), 'cpu')
        got, _ = _equal(seqs, codes, rl, state, maxerrors, minoverlap, idx,
                        count, ids)
        assert len(got) > 0
        if ids is not None:
            assert (got[:, 0] >= 10 ** 6).all()


@pytest.mark.parametrize('Lpad', [64, 128, 192])
@pytest.mark.parametrize('nch', [4, 5])
def test_h1_arithmetic_deep_locus(nch, Lpad):
    ''' one read repeated against a periodic template: whole warps whose
        every lane has pairs with w > 0, in the stages of one residue '''
    seqs, codes, rl, bank = periodic_case(nch, 130, Lpad)
    state = tps.device_arrays(bank, len(seqs), 'cpu')
    got, w = _equal(seqs, codes, rl, state, 2, MINOVERLAP)
    assert len(got) > 10 * len(codes)
    assert full_warps(w) >= 8
