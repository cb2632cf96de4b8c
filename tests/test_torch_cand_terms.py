'''
K1's arithmetic on the CPU: the count of csrc/cand_screen.cu computed in
plain torch the way the kernel computes it -- the match counts of its
staged operands (the rows' one-hot tile against the window rows of
``BankState.onehot``) in ``s1_columns`` order, the last group's padding
columns included, screened against the clamped 16-bit halves of
``BankState.sterms`` with ``k = e + 1`` moved into the terms, each pair's
pass bit the sum clamped to [0, 1] -- equals ``cand_counts_ref`` and the
Pallas kernel of kvarq_tpu (``match_cand_call``, interpret mode) summed
over its partials.  Every quantity is an integer count: the comparisons
are exact equality.
'''

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvarq_tpu.engine import encode
from kvarq_tpu.engine import pallas_scan as jps
from kvarq_tpu_torch import parallel
from kvarq_tpu_torch.engine import pallas_scan as tps

from _torch_cases import case

TB, TQ = 8, 128
INT16_MAX = 32767


def k1_counts(codes, rl, state, maxerrors, minoverlap):
    ''' K1's per-read counts as the kernel computes them, in plain torch;
        asserts that every intermediate of its 16-bit halves fits them '''
    nch, Lpad, Qp = state.nch, state.Lpad, state.Qp
    SP, DP = tps.s1_depth(Lpad, nch)
    R = 16 // SP
    B = codes.shape[0]
    # the rows' one-hot tile: SP bytes a position (A C G T [N 0 0 0]),
    # zero past the read padding up to whole k32 steps
    a = torch.zeros(B, Lpad, SP, dtype=torch.int64)
    a[..., :nch] = (codes.long()[..., None] == torch.arange(nch)).long()
    A = torch.nn.functional.pad(a.reshape(B, SP * Lpad), (0, DP - SP * Lpad))
    # MMA column c of stage k of group g scores column q; its window row
    # starts 16 c bytes into residue s's window of the stage, that is at
    # SP (q - s) of copy s of the one-hot bank
    q = torch.from_numpy(tps.s1_columns(Qp, nch)).long()
    s = q % R
    rows = state.onehot.long()[s[:, None], SP * (q - s)[:, None]
                               + torch.arange(DP)]
    m = A @ rows.T                                         # [B, columns]
    # the terms' halves (minus dm, ovc, seql), MMA columns 2 i and 2 i + 1
    halves = state.sterms.numpy()[:, :3].view(np.uint32)
    col = np.empty((len(q), 3), dtype=np.int64)
    col[0::2] = (halves & 0xFFFF).astype(np.uint16).view(np.int16)
    col[1::2] = (halves >> 16).astype(np.uint16).view(np.int16)
    col = torch.from_numpy(col)
    k = maxerrors + 1
    clamp = tps.S1_TERM_CLAMP
    rlv = torch.clamp(rl.long(), max=clamp)[:, None]
    rlmo = torch.clamp(torch.where(rlv > 0, torch.clamp(rlv, max=minoverlap),
                                   tps.BIG_RL_THRESHOLD), max=clamp)
    nrl, nrlmo = k - rlv, k - rlmo
    ovc = torch.clamp(col[:, 1] + k, max=INT16_MAX)
    sq = torch.clamp(col[:, 2] + k, max=INT16_MAX)
    first = nrl + col[:, 0]
    nthr = torch.minimum(torch.maximum(first, ovc), torch.maximum(nrlmo, sq))
    x = m + nthr
    for v in (nrl, nrlmo, ovc, sq, first, nthr, x):
        assert int(v.abs().max()) <= INT16_MAX
    return torch.clamp(x, 0, 1).sum(dim=1).to(torch.int32)


def pallas_counts(codes, rl, state, maxerrors, minoverlap):
    ''' kvarq_tpu's match_cand_call (interpret mode) on the state's K and
        qmeta, the batch padded to whole TB-row blocks with empty reads,
        summed over its partials '''
    B, Lpad, nch = len(codes), state.Lpad, state.nch
    Bp = -(-B // TB) * TB
    codes = np.concatenate([codes, np.full((Bp - B, Lpad),
                                           encode.CODE_READ_JUNK, np.uint8)])
    rl = np.concatenate([rl, np.zeros(Bp - B, np.int32)])
    call = jps.match_cand_call(Lpad, state.Qp, Bp, maxerrors, minoverlap,
                               TB=TB, TQ=TQ, interpret=True, nch=nch)
    read_flat = jax.nn.one_hot(jnp.asarray(codes), nch,
                               dtype=jnp.bfloat16).reshape(Bp, Lpad * nch)
    rl2d = jnp.broadcast_to(jnp.asarray(rl)[:, None], (Bp, 128))
    K = jnp.asarray(state.K.numpy(), dtype=jnp.bfloat16)
    out = call(read_flat, rl2d, K, jnp.asarray(state.qmeta.numpy()))
    return np.asarray(out).sum(axis=0)[:B]


def _reads(seed, nch, B, Lpad, nseq):
    ''' a case (_torch_cases.case, the first seed from ``seed`` on whose
        shift columns are no multiple of the 512-column group) with every
        fifth read given length 0, its codes kept (it still matches
        bases), and every seventh an empty read '''
    while True:
        seqs, codes, rl, bank = case(seed, nch, B=B, Lpad=Lpad, nseq=nseq)
        if (bank.Q + tps.QALIGN - 1) // tps.QALIGN % 4:
            break
        seed += 1000
    rl[::5] = 0
    codes[3::7] = encode.CODE_READ_JUNK
    rl[3::7] = 0
    return seqs, codes, rl, bank


def _equal(codes, rl, state, maxerrors, minoverlap):
    ''' the three counts agree exactly; :returns: them '''
    c, r = torch.from_numpy(codes), torch.from_numpy(rl)
    got = k1_counts(c, r, state, maxerrors, minoverlap)
    want = tps.cand_counts_ref(c, r, state, maxerrors, minoverlap, state.nch)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(
        got.numpy(), pallas_counts(codes, rl, state, maxerrors, minoverlap))
    return got


@pytest.mark.parametrize('minoverlap', [3, 25])
@pytest.mark.parametrize('maxerrors', [0, 1, 2, 3])
@pytest.mark.parametrize('Lpad', [64, 128, 192])
@pytest.mark.parametrize('nch', [4, 5])
def test_k1_arithmetic_equals_ref_and_pallas(nch, Lpad, maxerrors,
                                             minoverlap):
    ''' 130 reads (one row tile and two reads) against a bank whose Qp is
        no multiple of the 512-column group '''
    seqs, codes, rl, bank = _reads(Lpad + nch, nch, 130, Lpad, 9)
    state = tps.device_arrays(bank, len(seqs), 'cpu')
    assert state.nch == nch and state.Qp % tps.S1_GROUP
    got = _equal(codes, rl, state, maxerrors, minoverlap)
    assert (got > 0).any() and (got == 0).any()
    # a read of length 0 with bases in it (BIG_RL_THRESHOLD) passes where
    # its count reaches a template's length
    assert (rl == 0).sum() > 10


@pytest.mark.parametrize('nch', [4, 5])
def test_k1_arithmetic_one_read(nch):
    seqs, codes, rl, bank = case(80 + nch, nch, B=1, Lpad=64, nseq=5)
    state = tps.device_arrays(bank, len(seqs), 'cpu')
    for maxerrors, minoverlap in ((0, 25), (3, 3)):
        _equal(codes, rl, state, maxerrors, minoverlap)


@pytest.mark.parametrize('nch', [4, 5])
def test_k1_arithmetic_on_bank_shards(nch):
    ''' each state of a bank split in two (common G and Qp, the whole
        bank's channel count, global template numbering) '''
    seed = 90 + nch
    while True:     # shards whose Qp is no multiple of the group either
        seqs, codes, rl, _ = _reads(seed, nch, 130, 128, 12)
        sbank = parallel.ShardBank(seqs, 128, 2, 25)
        if sbank.Qp % tps.S1_GROUP:
            break
        seed += 1000
    assert sbank.nch == nch
    found = 0
    for j in range(2):
        state = sbank.state(j, 'cpu')
        assert state.Qp == sbank.Qp
        for maxerrors, minoverlap in ((0, 25), (2, 25), (3, 3)):
            found += int((_equal(codes, rl, state, maxerrors, minoverlap)
                          > 0).sum())
    assert found > 0
