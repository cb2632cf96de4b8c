'''
kvarq_tpu_torch.engine.pallas_scan against kvarq_tpu.engine.pallas_scan:
bank state, the candidate screen (plain version on the CPU, the CUDA
kernel where a card is present) and the scan step in dense, gathered and
overflow-fallback modes.  Every quantity is an integer count, so every
comparison is exact equality.
'''

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvarq_tpu.engine import pallas_scan as jps
from kvarq_tpu.engine.tensor_scan import (
    bank_device_arrays, build_bank, scan_step_fn)
from kvarq_tpu_torch import engine as tengine
from kvarq_tpu_torch.engine import pallas_scan as tps

from _torch_cases import case as _case
from test_pallas_scan import _random_case

TB, TQ = 8, 128


@pytest.fixture(autouse=True)
def reset_torch_engine_config():
    ''' every test starts from the port engine's built-in defaults '''
    tengine.config(maxerrors=0, minoverlap=20, minreadlength=10,
                   nthreads=1, Amin='!', Azero='!', device='cpu',
                   sieve=os.environ.get('KVARQ_SIEVE', 'auto'),
                   batchsize=int(os.environ.get('KVARQ_BATCHSIZE', '16384')))
    yield


def _jax_state(bank, T):
    qmeta = jps.pack_qmeta(bank, TQ)
    Qp = qmeta.shape[1]
    tseg = jps.pack_tseg(bank, T, TQ, Qp)
    K = jps.build_K_np(bank.codes, bank.Lpad, Qp)
    return K, qmeta, tseg


@pytest.mark.parametrize('nch', [4, 5])
@pytest.mark.parametrize('maxerrors,minoverlap', [(0, 25), (2, 25), (3, 8)])
def test_cand_counts_ref_matches_pallas(maxerrors, minoverlap, nch):
    ''' the plain candidate screen equals the Pallas kernel (interpret
        mode) summed over its [8*nQ, B] partials '''
    seqs, codes, rl, bank = _case(40 + maxerrors, nch, minoverlap=minoverlap)
    Lpad, B, T = bank.Lpad, len(codes), len(seqs)
    K, qmeta, tseg = _jax_state(bank, T)
    call = jps.match_cand_call(Lpad, qmeta.shape[1], B, maxerrors, minoverlap,
                               TB=TB, TQ=TQ, interpret=True, nch=nch)
    read_flat = jax.nn.one_hot(jnp.asarray(codes), nch,
                               dtype=jnp.bfloat16).reshape(B, Lpad * nch)
    rl2d = jnp.broadcast_to(jnp.asarray(rl)[:, None], (B, 128))
    want = np.asarray(call(read_flat, rl2d, jnp.asarray(K),
                           jnp.asarray(qmeta))).sum(axis=0)

    state = tps.state_from_numpy(K.astype(np.float32), qmeta, tseg, Lpad,
                                 bank.G, T, 'cpu')
    got = tps.cand_counts(torch.from_numpy(codes), torch.from_numpy(rl),
                          state, maxerrors, minoverlap, nch)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want > 0).any() and (want == 0).any()
    own = tps.device_arrays(bank, T, 'cpu')
    np.testing.assert_array_equal(
        tps.cand_counts_ref(torch.from_numpy(codes), torch.from_numpy(rl),
                            own, maxerrors, minoverlap, nch).numpy(), want)


@pytest.mark.parametrize('nch', [4, 5])
def test_state_from_numpy_matches_device_arrays(nch):
    seqs, _, _, bank = _case(3, nch)
    T = len(seqs)
    K, qmeta, tseg = _jax_state(bank, T)
    a = tps.state_from_numpy(K.astype(np.float32), qmeta, tseg, bank.Lpad,
                             bank.G, T, 'cpu')
    b = tps.device_arrays(bank, T, 'cpu')
    for f in ('Lpad', 'G', 'Qp', 'T', 'nch'):
        assert getattr(a, f) == getattr(b, f), f
    assert a.nch == nch and a.Qp == qmeta.shape[1]
    for f in ('K', 'bank', 'qmeta', 'tseg', 'onehot', 'sterms'):
        np.testing.assert_array_equal(getattr(a, f).numpy(),
                                      getattr(b, f).numpy(), err_msg=f)
    np.testing.assert_array_equal(b.K.numpy(), K.astype(np.float32))


@pytest.mark.parametrize('gather_k,seed', [(0, 13), (8, 42), (1, 7)],
                         ids=['dense', 'gathered', 'fallback'])
def test_scan_step_banked_matches_jax(gather_k, seed):
    ''' the Pallas step (interpret mode) dense, gathered (candidates fit
        its gather_k) and overflow-fallback, and the XLA twin, equal the
        port's step scoring every row (dense) or screened (the other two) '''
    rng = np.random.RandomState(seed)
    Lpad, B, e, mo = 64, 16, 1, 10
    seqs, codes, rl, _ = _random_case(rng, nseq=4, B=B, Lpad=Lpad)
    T = len(seqs)
    bank = build_bank(seqs, Lpad, mo)

    xla = scan_step_fn(Lpad, bank.G, T, e, mo, dtype_name='float32')(
        jnp.asarray(codes), jnp.asarray(rl),
        **bank_device_arrays(bank, dtype=jnp.float32))
    pstep = jps.scan_step(Lpad, bank, T, e, mo, B, gather_k=gather_k,
                          interpret=True, TB=TB, TQ=TQ, with_count=True)
    pal = pstep(jnp.asarray(codes), jnp.asarray(rl),
                **jps.device_arrays(bank, TQ=TQ))

    state = tps.device_arrays(bank, T, 'cpu')
    bc, sh, sbh, count = tps.scan_step_banked(
        torch.from_numpy(codes), torch.from_numpy(rl), state, e, mo,
        gather_k != 0)
    got = (bc.numpy(), sh.numpy(), sbh.numpy())
    for name, x, p, g in zip(('basecount', 'seqhits', 'seqbasehits'),
                             xla, pal, got):
        np.testing.assert_array_equal(np.asarray(x), g, err_msg=name)
        np.testing.assert_array_equal(np.asarray(p), g, err_msg=name)
    assert count.dtype == torch.int32 and count.dim() == 0
    assert int(count) == int(np.asarray(pal[3]))
    if gather_k == 8:
        assert 0 < count <= 8          # the gathered branch ran
    if gather_k == 1:
        assert count > 1               # the fallback branch ran
    assert np.asarray(xla[1]).sum() > 0


@pytest.mark.parametrize('screen', [False, True], ids=['0', '1'])
@pytest.mark.parametrize('rows', [1, 5, 16])
def test_scoring_in_passes_matches_one_pass(screen, rows):
    ''' a rows bound on exact scoring (steps scoring every row, and
        screened steps) splits the work into passes and changes no count '''
    rng = np.random.RandomState(3)
    seqs, codes, rl, _ = _random_case(rng, nseq=4, B=16, Lpad=64)
    state = tps.device_arrays(build_bank(seqs, 64, 10), len(seqs), 'cpu')
    args = (torch.from_numpy(codes), torch.from_numpy(rl), state, 1, 10,
            screen)
    want = tps.scan_step_banked(*args)
    got = tps.scan_step_banked(*args, rows=rows)
    for w, g in zip(want[:3], got[:3]):
        np.testing.assert_array_equal(w.numpy(), g.numpy())
    assert want[3] == got[3]
    assert want[1].sum() > 0


@pytest.mark.parametrize('mask,size', [
    ([False, True, False, True, True], 2),
    ([False, True, False, True, True], 5),
    ([False] * 6, 4),
    ([True] * 6, 6),
    ([True] * 6, 3),
    ([], 0),
    ('random', 40),
    ('random', 200),
], ids=['nonzero_static', 'nonzero_static_full', 'empty', 'full',
        'full_overflow', 'no_entries', 'random_overflow', 'random'])
def test_compact_matches_jnp_nonzero(mask, size):
    ''' the device compaction equals jnp.nonzero(mask, size, fill_value=0)
        and counts every set entry, past ``size`` too; its default size
        is the whole mask '''
    if mask == 'random':
        mask = np.random.RandomState(size).rand(100) < 0.6
    mask = np.asarray(mask, dtype=bool)
    idx, count = tps.compact(torch.from_numpy(mask), size)
    assert idx.dtype == count.dtype == torch.int32 and count.dim() == 0
    want = np.asarray(jnp.nonzero(jnp.asarray(mask), size=size,
                                  fill_value=0)[0])
    np.testing.assert_array_equal(idx.numpy(), want)
    assert int(count) == mask.sum()
    full, count = tps.compact(torch.from_numpy(mask))
    np.testing.assert_array_equal(full.numpy()[:mask.sum()],
                                  np.flatnonzero(mask))
    assert len(full) == len(mask) and int(count) == mask.sum()


@pytest.mark.parametrize('gather_k,seed', [(0, 13), (8, 42), (1, 7)],
                         ids=['dense', 'gathered', 'overflow'])
def test_score_candidates_ref_matches_jax(gather_k, seed):
    ''' the plain scoring of ``idx[:count]`` -- every row, or the rows
        the screen flags compacted on the device -- equals the Pallas step
        (interpret mode) with its compacted and full-batch branches '''
    rng = np.random.RandomState(seed)
    Lpad, B, e, mo = 64, 16, 1, 10
    seqs, codes, rl, _ = _random_case(rng, nseq=4, B=B, Lpad=Lpad)
    T = len(seqs)
    bank = build_bank(seqs, Lpad, mo)
    pstep = jps.scan_step(Lpad, bank, T, e, mo, B, gather_k=gather_k,
                          interpret=True, TB=TB, TQ=TQ, with_count=True)
    want = pstep(jnp.asarray(codes), jnp.asarray(rl),
                 **jps.device_arrays(bank, TQ=TQ))

    state = tps.device_arrays(bank, T, 'cpu')
    c, r = torch.from_numpy(codes), torch.from_numpy(rl)
    if gather_k:
        hit = tps.cand_counts_ref(c, r, state, e, mo, state.nch) > 0
        idx, count = tps.compact(hit)
        assert int(count) == int(np.asarray(want[3]))
        assert (int(count) > gather_k) == (gather_k == 1)
        got = tps.score_candidates_ref(c, r, state, e, mo, idx, count)
        via = tps.score_candidates(c, r, state, e, mo, idx, count, gather_k)
    else:
        got = tps.score_candidates_ref(c, r, state, e, mo)
        via = tps.score_candidates(c, r, state, e, mo)
    for name, w, g, v in zip(('basecount', 'seqhits', 'seqbasehits'),
                             want, got, via):
        np.testing.assert_array_equal(np.asarray(w), g.numpy(), err_msg=name)
        np.testing.assert_array_equal(g.numpy(), v.numpy(), err_msg=name)
    assert np.asarray(want[1]).sum() > 0


def test_score_candidates_rejects_bad_input():
    ''' S1's wrapper checks its arguments on either device, before it
        chooses the kernel or its plain version '''
    seqs, codes, rl, bank = _case(1, 4)
    state = tps.device_arrays(bank, len(seqs), 'cpu')
    c, r = torch.from_numpy(codes), torch.from_numpy(rl)
    idx, count = tps.compact(tps.cand_counts_ref(c, r, state, 0, 25, 4) > 0)
    bad = [dict(codes=c.to(torch.int32)), dict(rl=r.long()),
           dict(codes=c[:, :60]), dict(idx=idx.long(), count=count),
           dict(idx=idx, count=count.long()),
           dict(idx=idx, count=count.to('meta')),
           dict(idx=idx.to('meta'), count=count),
           dict(idx=torch.zeros(len(c) + 1, dtype=torch.int32)),
           dict(idx=idx, count=torch.zeros(2, dtype=torch.int32)),
           dict(count=count)]
    for kw in bad:
        args = dict(codes=c, rl=r, idx=None, count=None)
        args.update(kw)
        with pytest.raises(ValueError):
            tps.score_candidates(args['codes'], args['rl'], state, 0, 25,
                                 args['idx'], args['count'])
    with pytest.raises(ValueError):
        tps.score_candidates(c.to('meta'), r.to('meta'),
                             tps.device_arrays(bank, len(seqs), 'meta'),
                             0, 25)


@pytest.mark.parametrize('nch', [4, 5])
@pytest.mark.parametrize('Lpad', [36, 64, 128, 192])
def test_s1_onehot_bank_is_the_moved_one_hot(nch, Lpad):
    ''' S1's one-hot bank: copy s is one_hot of the kernel bytes moved by
        s positions (SP bytes a position, the channels past nch zero); the
        window row of every column q (residue q % R, 16-byte aligned)
        reads K's column q '''
    seqs, _, _, bank = _case(60 + Lpad, nch, Lpad=Lpad, nseq=9)
    state = tps.device_arrays(bank, len(seqs), 'cpu')
    SP, DP = tps.s1_depth(Lpad, nch)
    R = 16 // SP
    oh = state.onehot.numpy()
    ngroups = -(-state.Qp // tps.S1_GROUP)
    assert oh.shape == (R, SP * tps.S1_GROUP * ngroups + DP)
    assert oh.shape[1] % 16 == 0
    kbytes = torch.from_numpy(
        tps._kernel_bytes(tps._padded_bank(bank.codes, Lpad, state.Qp), nch))
    assert torch.equal(kbytes, state.bank)
    npos = oh.shape[1] // SP
    for s in range(R):
        moved = torch.full((npos,), tps.BANK_SENTINEL, dtype=torch.uint8)
        part = kbytes[s:s + npos]
        moved[:len(part)] = part
        want = torch.zeros((npos, SP), dtype=torch.uint8)
        want[:, :nch] = tps.one_hot(moved, nch, torch.uint8)
        np.testing.assert_array_equal(oh[s].reshape(npos, SP), want.numpy(),
                                      err_msg='copy %d' % s)
    K = state.K.numpy().reshape(Lpad, nch, state.Qp)
    for q in range(0, state.Qp, 7):
        s = q % R
        row = oh[s, SP * (q - s):SP * (q - s) + SP * Lpad].reshape(Lpad, SP)
        np.testing.assert_array_equal(row[:, :nch], K[:, :, q],
                                      err_msg='column %d' % q)
        assert not row[:, nch:].any()


@pytest.mark.parametrize('nch', [4, 5])
@pytest.mark.parametrize('maxerrors,minoverlap', [(0, 25), (2, 25), (3, 8)])
def test_s1_terms_screen_equals_cand_counts_ref(nch, maxerrors, minoverlap):
    ''' S1's screen terms in stage order: every shift column once, in the
        halves of the row of its MMA column pair; the screen with the
        errors on the count's side, over them and the clamped row terms,
        passes exactly the pairs of cand_counts_ref '''
    seqs, codes, rl, bank = _case(70 + maxerrors, nch, B=40,
                                  minoverlap=minoverlap, nseq=12)
    state = tps.device_arrays(bank, len(seqs), 'cpu')
    terms = state.sterms.numpy()
    q = tps.s1_columns(state.Qp, nch)
    ngroups = -(-state.Qp // tps.S1_GROUP)
    assert terms.shape == (ngroups * tps.S1_STAGES * 64, 4)
    assert sorted(q[q < state.Qp]) == list(range(state.Qp))
    halves = terms[:, :3].view(np.uint32)
    col = np.empty((len(q), 3), dtype=np.int64)
    col[0::2] = -(halves & 0xFFFF).astype(np.int16)
    col[1::2] = -(halves >> 16).astype(np.int16)
    assert not terms[:, 3].any()
    assert (col[q >= state.Qp] == tps.S1_TERM_CLAMP).all()
    cq = np.empty((state.Qp, 3), dtype=np.int64)
    cq[q[q < state.Qp]] = col[q < state.Qp]
    c_, r_ = torch.from_numpy(codes), torch.from_numpy(rl)
    m = tps.match_counts(c_, state.K, nch).long().numpy()
    clamp = tps.S1_TERM_CLAMP
    rlv = np.minimum(rl.astype(np.int64), clamp)[:, None]
    rlmo = np.minimum(np.where(rlv > 0, np.minimum(rlv, minoverlap),
                               tps.BIG_RL_THRESHOLD), clamp)
    thr = np.maximum(np.minimum(rlv + cq[:, 0], cq[:, 1]),
                     np.minimum(rlmo, cq[:, 2]))
    got = (m + maxerrors >= thr).sum(axis=1)
    want = tps.cand_counts_ref(c_, r_, state, maxerrors, minoverlap, nch)
    np.testing.assert_array_equal(got, want.numpy())
    assert (got > 0).any()


def test_one_hot_drops_out_of_range_codes():
    codes = torch.tensor([[0, 3, 4, 5, 6]], dtype=torch.uint8)
    for nch in (4, 5):
        np.testing.assert_array_equal(
            tps.one_hot(codes, nch, torch.float32).numpy(),
            np.asarray(jax.nn.one_hot(jnp.asarray(codes.numpy()), nch)))
