'''
Exhaustive scan step of the port (counterpart of
kvarq_tpu/engine/pallas_scan.py): bank tensors, the candidate screen and
the exact scoring of one batch of reads.

- :py:func:`pack_qmeta` / :py:func:`pack_tseg` / :py:func:`bank_channels`
  lay out the per-column metadata (copies of kvarq_tpu's numpy helpers);
  :py:func:`device_arrays` / :py:func:`state_from_numpy` build the
  :py:class:`BankState` (im2col'd one-hot bank ``K``, padded bank bytes,
  ``qmeta``, ``tseg``, and S1's staged one-hot bank and screen terms,
  :py:func:`s1_onehot`, :py:func:`s1_terms`) from a
  :py:class:`~kvarq_tpu_torch.engine.match_xla._Bank` or from the JAX
  package's numpy bank state.
- :py:func:`cand_counts` is the candidate screen: on a CUDA tensor it
  launches the hand-written kernel csrc/cand_screen.cu (K1, the port of
  the TPU kernel ``_cand_kernel``: S1's pipeline with a drain that counts
  each read's passing columns), on a CPU tensor its plain version
  :py:func:`cand_counts_ref`.
- :py:func:`score_candidates` is the exact scoring of a list of rows:
  on a CUDA tensor the hand-written kernel csrc/score_step.cu (S1: the
  match product with a ``mode_weights`` epilogue and the coverage fold,
  int64 atomics, one persistent block per SM whatever the count; the
  device work kvarq_tpu leaves to XLA in ``score_full``), on a CPU
  tensor its plain version :py:func:`score_candidates_ref`.
- :py:func:`hit_triplets` is the exact hit extraction of a list of rows:
  on a CUDA tensor the kernel H1 (S1's pipeline in csrc/score_step.cu
  with a drain that writes each passing ``(row, template, shift)``
  triplet into a buffer at a slot taken by an atomic counter; the device
  work kvarq_tpu leaves to XLA in ``match_xla._jit_step``), on a CPU
  tensor its plain version :py:func:`hit_triplets_ref`.
- :py:func:`scan_step_banked` is one device step that scores every read
  or screens them (the screen, compaction on the device with
  :py:func:`compact`, exact scoring of every candidate).  On
  the card it never waits on the host.

Exact scoring keeps the JAX package's quantities but not its layout: the
per-template sums and the coverage are accumulated from the ``(read,
shift)`` pairs of non-zero weight in int64 -- the same counts as the
``read5.T @ w`` contraction plus diagonal fold, with no ``[Lpad*5, Q]``
intermediate and no reduced-precision product.
'''

import ctypes
import dataclasses

import numpy as np
import torch

from kvarq_tpu_torch.engine import encode, native_cuda

# q-metadata row indices in the packed [8, Qp] int32 array.  Rows 0-2
# feed the exact mode_weights recompute outside the kernel; rows 3-4 are
# the kernel-side candidate-screen precomputations:
# DM = min(d, 0) (the read-side offset of the overlap window) and
# OVC = seql - max(0, d) (the column part of the overlap length), set to
# -2^20 on invalid/padded columns so the overlap goes so negative that
# the screen can never pass there.
ROW_D, ROW_SEQL, ROW_VALID = 0, 1, 2
ROW_DM, ROW_OVC = 3, 4
INVALID_OVC = -(1 << 20)
BIG_RL_THRESHOLD = 1 << 20

# the JAX package's default column tile (pack_qmeta's padding when no Qp
# is given)
DEF_TQ = 2048

# shift columns are padded to a multiple of the kernel's column tile
QALIGN = 128
# bank bytes the kernel must never match (codes >= nch, padding)
BANK_SENTINEL = 0xFE
# largest Lpad whose match counts fp16 holds exactly (integers <= 2048)
FP16_MAX_LPAD = 2048


def _ceil_to(x, m):
    return -(-x // m) * m


def bank_channels(bank_codes):
    ''' one-hot channels needed to match this bank exactly: 4 (ACGT) when
        the bank is N-free -- read N one-hots to zero and thus mismatches,
        which is exact since nothing in the bank could match it -- else
        the full 5 '''
    return encode.NBASE if (np.asarray(bank_codes) == encode.N).any() \
        else encode.NBASE - 1


def pack_qmeta(bank, TQ=DEF_TQ, Qp=None):
    ''' pack per-shift-column metadata into one sublane-aligned [8, Qp]
        int32 array (rows: see the ROW_* constants) '''
    Q = bank.Q
    if Qp is None:
        Qp = max(_ceil_to(Q, TQ), TQ)
    qmeta = np.zeros((8, Qp), dtype=np.int32)
    qmeta[ROW_SEQL, :] = 1
    qmeta[ROW_D, :Q] = bank.d_of
    qmeta[ROW_SEQL, :Q] = bank.seql_of
    valid = np.zeros(Qp, dtype=bool)
    valid[:Q] = bank.tid >= 0
    qmeta[ROW_VALID] = valid
    # kernel-side candidate-screen precomputations (see ROW_DM, ROW_OVC)
    qmeta[ROW_DM] = np.where(valid, np.minimum(0, qmeta[ROW_D]), 0)
    qmeta[ROW_OVC] = np.where(
        valid, qmeta[ROW_SEQL] - np.maximum(0, qmeta[ROW_D]), INVALID_OVC)
    return qmeta


def pack_tseg(bank, T, TQ=DEF_TQ, Qp=None):
    ''' Q -> template-id segment map padded to Qp (invalid columns map to
        the discard segment T) '''
    if Qp is None:
        Qp = max(_ceil_to(bank.Q, TQ), TQ)
    tseg = np.full(Qp, T, dtype=np.int32)
    tseg[:bank.Q] = np.where(bank.tid >= 0, bank.tid, T)
    return tseg


@dataclasses.dataclass
class BankState:
    ''' device tensors of one template bank at one read padding ``Lpad`` '''
    Lpad: int
    G: int            # bank length (templates plus gaps)
    Qp: int           # padded shift columns
    T: int            # templates; seqhits slot T collects the gap columns
    nch: int          # one-hot channels of K (bank_channels)
    K: torch.Tensor       # [Lpad*nch, Qp] one-hot im2col'd bank
    bank: torch.Tensor    # uint8 [4*n] bank bytes for the kernel
    qmeta: torch.Tensor   # int32 [8, Qp] (pack_qmeta rows)
    tseg: torch.Tensor    # int32 [Qp] column -> template, T for gaps
    onehot: torch.Tensor  # uint8 [R, nb] S1's one-hot bank (s1_onehot)
    sterms: torch.Tensor  # int32 [groups*S1_STAGES*64, 4] (s1_terms)


def _match_dtype(device, Lpad):
    ''' operand type of the one-hot match product: fp16 on the card (every
        partial sum is an integer <= Lpad, exact in fp16 up to 2048 whatever
        the accumulation precision; bf16 would stop at 256), f32 on the
        CPU '''
    if torch.device(device).type == 'cuda' and Lpad <= FP16_MAX_LPAD:
        return torch.float16
    return torch.float32


def _padded_bank(codes, Lpad, Qp):
    ''' bpad[i] = bank[i - (Lpad-1)], template junk outside the bank, for
        i in [0, Qp + Lpad - 1): column q of K reads bpad[q:q + Lpad] '''
    bpad = np.full(Qp + Lpad - 1, encode.CODE_TMPL_JUNK, dtype=np.uint8)
    bpad[Lpad - 1:Lpad - 1 + len(codes)] = codes
    return bpad


def _kernel_bytes(bpad, nch):
    ''' bank bytes as the kernel reads them: codes >= nch (and the tail
        padding to whole 32-bit words) become BANK_SENTINEL '''
    out = np.full(-(-len(bpad) // 4) * 4, BANK_SENTINEL, dtype=np.uint8)
    out[:len(bpad)] = np.where(bpad < nch, bpad, BANK_SENTINEL)
    return out


# the schedule of S1, H1 and K1 (csrc/kvq_s1_pipeline.h): shift columns per
# column group, whose bank windows and screen terms are staged together,
# and MMA stages (128 columns each) per group
S1_GROUP = 512
S1_STAGES = 4
# screen terms past Qp: a threshold no count reaches (at the clamp)
S1_NEVER = 1 << 29


def s1_depth(Lpad, nch):
    ''' ``(SP, DP)``: S1's depth bytes per read position (4 for nch 4: A C
        G T; 8 for nch 5: A C G T N and three zero bytes) and the depth
        bytes its MMAs read, whole k32 steps of 32 bytes '''
    SP = 4 if nch == 4 else 8
    return SP, -(-SP * Lpad // 32) * 32


def s1_onehot(kbytes, nch, Lpad, Qp):
    '''
    S1's one-hot bank, from which its bank windows are copied: uint8 ``[R,
    nb]``, R = 16 / SP copies of the one-hot of the kernel bytes
    (:py:func:`_kernel_bytes`; SP bytes per position, :py:func:`s1_depth`;
    the sentinel and positions past the bytes all zero), copy ``s``
    moved by ``s`` positions: ``out[s, i] = flat[SP * s + i]``.  So the
    window of residue ``s`` (columns ``q = s (mod R)``) of every column
    group starts on a 16-byte boundary of copy ``s``, at ``SP * q0``
    for the group's first column ``q0``.  ``nb`` covers every group's
    window, ``SP * S1_GROUP`` bytes plus the MMAs' depth.
    '''
    SP, DP = s1_depth(Lpad, nch)
    R = 16 // SP
    nb = SP * S1_GROUP * -(-Qp // S1_GROUP) + DP
    kb = np.full(nb // SP + R, BANK_SENTINEL, dtype=np.uint8)
    n = min(len(kbytes), len(kb))
    kb[:n] = kbytes[:n]
    flat = (kb[:, None] == np.arange(SP, dtype=np.uint8)).astype(np.uint8)
    flat = flat.reshape(-1)
    return np.stack([flat[SP * s:SP * s + nb] for s in range(R)])


# the screen terms' clamp: the comparisons with a count plus e (at most
# Lpad + e, far below it) come out as they would unclamped
S1_TERM_CLAMP = 16383


def s1_columns(Qp, nch):
    ''' the shift column that MMA column ``c`` of stage ``k`` of column
        group ``g`` scores, in the order ``(g, k, c)``: ``g * S1_GROUP + (k
        // R) * 128 * R + k % R + R * c`` (R = 16 / SP residues); columns
        past ``Qp`` are the last group's padding '''
    SP, _ = s1_depth(1, nch)
    R = 16 // SP
    g = np.arange(-(-Qp // S1_GROUP))[:, None, None]
    k = np.arange(S1_STAGES)[None, :, None]
    c = np.arange(128)[None, None, :]
    return (g * S1_GROUP + (k // R) * 128 * R + k % R + R * c).reshape(-1)


def s1_terms(qmeta, nch):
    '''
    S1's screen terms in its stage order: int32 ``[groups * S1_STAGES * 64,
    4]``, row ``i`` for the columns ``q0, q1`` of MMA columns ``2 i % 128``
    and ``2 i % 128 + 1`` (:py:func:`s1_columns`): three words of two
    16-bit halves, minus ``dm``, ``ovc`` and ``seql`` of ``q0`` (low) and
    ``q1`` (high), each clamped to +-:py:data:`S1_TERM_CLAMP`, and a zero
    word.  ``dm`` and ``ovc`` are qmeta's ``ROW_DM`` and ``ROW_OVC``,
    ``seql`` the template length where the column is valid (else
    ``BIG_RL_THRESHOLD``), all three :py:data:`S1_NEVER` past ``Qp``.  The
    screen of :py:func:`cand_counts_ref` passes a pair when ``matches + e
    >= max(min(rl + dm, ovc), min(rlmo, seql))`` with ``rl`` and ``rlmo``
    (``min(rl, mo)``, ``BIG_RL_THRESHOLD`` for an empty row) clamped alike:
    the errors move to the count's side, and a threshold at the clamp is
    one that no count reaches.
    '''
    Qp = qmeta.shape[1]
    q = s1_columns(Qp, nch)
    ok = q < Qp
    qc = np.where(ok, q, 0)
    terms = np.stack([
        qmeta[ROW_DM, qc], qmeta[ROW_OVC, qc],
        np.where(qmeta[ROW_VALID, qc] > 0, qmeta[ROW_SEQL, qc],
                 BIG_RL_THRESHOLD)], axis=1).astype(np.int64)
    terms[~ok] = S1_NEVER
    half = -np.clip(terms, -S1_TERM_CLAMP, S1_TERM_CLAMP) & 0xFFFF
    out = np.zeros((len(q) // 2, 4), dtype=np.uint32)
    out[:, :3] = half[0::2] | half[1::2] << 16
    return out.view(np.int32)


def one_hot(codes, nch, dtype):
    ''' one-hot by comparison: codes >= nch (junk, and N when nch is 4)
        give zero rows, as jax.nn.one_hot does (F.one_hot would raise) '''
    return (codes[..., None].long()
            == torch.arange(nch, device=codes.device)).to(dtype)


def build_K(bpad, Lpad, Qp, nch, dtype):
    ''' im2col'd one-hot bank K[(j, c), q] = onehot(bpad[q + j])[c] from
        the padded bank codes (a tensor) '''
    win = bpad.unfold(0, Lpad, 1)[:Qp]                    # [Qp, Lpad]
    return one_hot(win, nch, dtype).permute(1, 2, 0).reshape(Lpad * nch, Qp)


def _state(bpad, qmeta, tseg, Lpad, G, T, nch, device, K=None):
    device = torch.device(device)
    dtype = _match_dtype(device, Lpad)
    Qp = qmeta.shape[1]
    if K is None:
        K = build_K(torch.from_numpy(bpad).to(device), Lpad, Qp, nch, dtype)
    else:
        K = torch.from_numpy(np.ascontiguousarray(K)).to(device, dtype)
    qmeta = np.ascontiguousarray(qmeta, np.int32)
    kbytes = _kernel_bytes(bpad, nch)
    return BankState(
        Lpad=Lpad, G=G, Qp=Qp, T=T, nch=nch, K=K.contiguous(),
        bank=torch.from_numpy(kbytes).to(device),
        qmeta=torch.from_numpy(qmeta).to(device),
        tseg=torch.from_numpy(np.ascontiguousarray(tseg, np.int32))
        .to(device),
        onehot=torch.from_numpy(s1_onehot(kbytes, nch, Lpad, Qp)).to(device),
        sterms=torch.from_numpy(s1_terms(qmeta, nch)).to(device))


def device_arrays(bank, T, device):
    ''' :py:class:`BankState` of a ``_Bank`` on ``device``; shift
        columns padded to a multiple of :py:data:`QALIGN` '''
    qmeta = pack_qmeta(bank, QALIGN)
    Qp = qmeta.shape[1]
    return _state(_padded_bank(bank.codes, bank.Lpad, Qp), qmeta,
                  pack_tseg(bank, T, QALIGN, Qp), bank.Lpad, bank.G, T,
                  bank_channels(bank.codes), device)


def state_from_numpy(K, qmeta, tseg, Lpad, G, T, device):
    ''' :py:class:`BankState` from the JAX package's bank state as numpy
        arrays: ``K`` from ``pallas_scan.build_K_np`` cast to float32,
        ``qmeta`` from ``pack_qmeta``, ``tseg`` from ``pack_tseg``.  The
        kernel's bank bytes are read back out of K (rows j=0 and
        j=Lpad-1 hold every padded bank position). '''
    K = np.asarray(K, dtype=np.float32)
    nch = K.shape[0] // Lpad
    Qp = K.shape[1]
    K3 = K.reshape(Lpad, nch, Qp)
    oh = np.concatenate([K3[0], K3[Lpad - 1][:, Qp - Lpad + 1:]], axis=1)
    bpad = np.where(oh.any(axis=0), oh.argmax(axis=0),
                    encode.CODE_TMPL_JUNK).astype(np.uint8)
    return _state(bpad, qmeta, tseg, Lpad, G, T, nch, device, K=K)


def match_counts(codes, K, nch):
    ''' [B, Qp] matching-base counts: one-hot reads @ K (a plain product,
        left to cuBLAS as the JAX package leaves it to XLA) '''
    flat = one_hot(codes, nch, K.dtype).reshape(codes.shape[0],
                                                codes.shape[1] * nch)
    return flat @ K


# --- candidate screen ---------------------------------------------------------

def _check_nch(state, nch):
    if nch != state.nch:
        raise ValueError('nch=%d but the bank state was built with %d '
                         'channels' % (nch, state.nch))


def cand_counts_ref(codes, rl, state, maxerrors, minoverlap, nch):
    ''' plain PyTorch version of :py:func:`cand_counts`: per-read count of
        shift columns passing the sound candidate screen of
        ``kvarq_tpu.engine.pallas_scan._cand_kernel`` (its module
        docstring derives it), in int32 '''
    _check_nch(state, nch)
    m = match_counts(codes, state.K, nch).to(torch.int32)     # [B, Qp]
    qm = state.qmeta
    rl = rl.to(torch.int32)[:, None]
    e = maxerrors
    rlmo_e = torch.where(rl > 0, torch.clamp(rl, max=minoverlap),
                         BIG_RL_THRESHOLD) - e
    seql_e = torch.where(qm[ROW_VALID] > 0, qm[ROW_SEQL] - e,
                         BIG_RL_THRESHOLD)
    ov_e = torch.minimum(rl + (qm[ROW_DM] - e), qm[ROW_OVC] - e)
    thr = torch.maximum(ov_e, torch.minimum(rlmo_e, seql_e[None, :]))
    return (m >= thr).sum(dim=1, dtype=torch.int32)


def _cand_lib():
    lib = native_cuda.load('cand_screen.cu')
    fn = lib.kvq_cand_screen
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, ctypes.c_long, vp, vp, i, i, i, i, i, i,
                       vp]
        fn.restype = ctypes.c_int
    return fn


def cand_counts(codes, rl, state, maxerrors, minoverlap, nch):
    '''
    per-read candidate-column counts ``[B] int32`` -- equal to
    ``match_cand_call(...)(...).sum(axis=0)`` of the JAX package (read b
    is a candidate iff its count is > 0).

    :param codes: uint8 ``[B, Lpad]`` read codes
    :param rl: int32 ``[B]`` read lengths (0 for padding rows)

    On a CPU tensor this is :py:func:`cand_counts_ref`.  On a CUDA tensor
    it launches csrc/cand_screen.cu (K1: one block per SM, reading the
    state's ``onehot`` and ``sterms``) on the current stream, or raises;
    ``cand_counts.launches`` counts those launches.
    '''
    if codes.device.type == 'cpu':
        return cand_counts_ref(codes, rl, state, maxerrors, minoverlap, nch)
    if codes.device.type != 'cuda':
        raise ValueError('cand_counts: unsupported device %s' % codes.device)
    _check_nch(state, nch)
    _check_args('cand_counts', codes, rl, state)
    B, Lpad = codes.shape
    if Lpad % 4 or codes.data_ptr() % 4:
        raise ValueError('cand_counts: Lpad and the codes pointer must be '
                         'multiples of 4')
    out = torch.zeros(B, dtype=torch.int32, device=codes.device)
    if B == 0:
        return out
    # the launch goes to the current device's context: make it codes'
    with torch.cuda.device(codes.device):
        err = _cand_lib()(
            codes.data_ptr(), rl.data_ptr(), state.onehot.data_ptr(),
            state.onehot.shape[1], state.sterms.data_ptr(), out.data_ptr(),
            B, Lpad, state.Qp, nch, maxerrors, minoverlap,
            torch.cuda.current_stream(codes.device).cuda_stream)
    if err:
        raise RuntimeError('cand_screen kernel launch failed: CUDA error %d'
                           % err)
    cand_counts.launches += 1
    return out


cand_counts.launches = 0


# --- exact scoring ------------------------------------------------------------

def _coverage(codes, b, q, w, state):
    ''' basecount[c, g] = sum over pairs (b, q) with weight w of the read
        bases codes[b, j] == c at g = q - (Lpad-1) + j -- the diagonal fold
        of read5.T @ w, as integer scatter-adds '''
    Lpad, G = state.Lpad, state.G
    bc = torch.zeros(encode.NBASE * G, dtype=torch.int64, device=codes.device)
    j = torch.arange(Lpad, device=codes.device)
    step = max(1, (1 << 24) // Lpad)      # bounds the [pairs, Lpad] temps
    for s in range(0, len(b), step):
        g = q[s:s + step, None] - (Lpad - 1) + j
        c = codes[b[s:s + step]].long()
        ok = (c < encode.NBASE) & (g >= 0) & (g < G)
        bc.index_add_(0, (c * G + g)[ok],
                      w[s:s + step, None].expand_as(g)[ok])
    return bc.view(encode.NBASE, G)


def _score(codes, rl, state, maxerrors, minoverlap):
    from kvarq_tpu_torch.engine.tensor_scan import mode_weights
    qm = state.qmeta
    m = match_counts(codes, state.K, state.nch)
    w, ov = mode_weights(m, rl[:, None], qm[ROW_D:ROW_D + 1],
                         qm[ROW_SEQL:ROW_SEQL + 1], qm[ROW_VALID:ROW_VALID + 1],
                         maxerrors, minoverlap)
    del m
    b, q = torch.nonzero(w, as_tuple=True)
    wv = w[b, q].long()
    ovv = ov[b, q].long()
    del w, ov
    seg = state.tseg[q].long()
    zeros = torch.zeros(state.T + 1, dtype=torch.int64, device=codes.device)
    seqhits = zeros.clone().index_add_(0, seg, wv)
    seqbasehits = zeros.index_add_(0, seg, wv * ovv)
    return _coverage(codes, b, q, wv, state), seqhits, seqbasehits


def score_candidates_ref(codes, rl, state, maxerrors, minoverlap, idx=None,
                         count=None, rows=None):
    ''' plain PyTorch version of :py:func:`score_candidates`: the rows
        ``idx[:count]`` (every row when ``idx`` is None; all of ``idx``
        when ``count`` is None) scored as kvarq_tpu's ``score_full``: the
        match product, ``mode_weights`` over ``[rows, Qp]``, the non-zero
        ``(read, shift)`` pairs, integer ``index_add_``.  It reads the
        count on the host.  ``rows`` bounds the reads per pass, and with
        it the ``[rows, Qp]`` temporaries (None: all at once). '''
    if idx is not None:
        n = len(idx) if count is None else int(count)
        sel = idx[:n].long()
        codes, rl = codes[sel], rl[sel]
    B = codes.shape[0]
    if not rows or rows >= B:
        return _score(codes, rl, state, maxerrors, minoverlap)
    total = None
    for s in range(0, B, rows):
        part = _score(codes[s:s + rows], rl[s:s + rows], state, maxerrors,
                      minoverlap)
        total = part if total is None else [t.add_(p) for t, p in
                                            zip(total, part)]
    return tuple(total)


def _score_lib():
    lib = native_cuda.load('score_step.cu')
    fn = lib.kvq_score_step
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, i, vp, i, vp, ctypes.c_long, vp, vp,
                       vp, vp, vp, vp, i, i, i, i, i, i, vp, vp]
        fn.restype = ctypes.c_int
    return fn


def _check_args(what, codes, rl, state, idx=None, count=None):
    ''' the types, shapes and devices that the kernels' wrappers
        (``what``: :py:func:`cand_counts`, :py:func:`score_candidates`,
        :py:func:`hit_triplets`) take; raises ValueError '''
    B = codes.shape[0] if codes.dim() == 2 else -1
    SP, DP = s1_depth(state.Lpad, state.nch)
    ngroups = -(-state.Qp // S1_GROUP)
    args = [('codes', codes, torch.uint8, (B, state.Lpad)),
            ('rl', rl, torch.int32, (B,)),
            ('bank', state.bank, torch.uint8, tuple(state.bank.shape)),
            ('qmeta', state.qmeta, torch.int32, (8, state.Qp)),
            ('tseg', state.tseg, torch.int32, (state.Qp,)),
            ('onehot', state.onehot, torch.uint8,
             (16 // SP, SP * S1_GROUP * ngroups + DP)),
            ('sterms', state.sterms, torch.int32,
             (ngroups * S1_STAGES * 64, 4))]
    if idx is not None:
        args.append(('idx', idx, torch.int32, (min(len(idx), B),)))
    if count is not None:
        if idx is None or count.numel() != 1:
            raise ValueError('%s: a count is one element, given with an idx'
                             % what)
        args.append(('count', count, torch.int32, tuple(count.shape)))
    for name, t, dtype, shape in args:
        if t.device != codes.device or t.dtype != dtype \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                '%s: %s must be a contiguous %s tensor of shape %s on %s '
                '(got %s %s on %s)' % (
                    what, name, dtype, shape, codes.device, t.dtype,
                    tuple(t.shape), t.device))


def _check_profile(what, profile, device):
    ''' a kernel's profile buffer: None, or a contiguous int64 tensor of
        :py:data:`PROFILE_PHASES` entries on ``device``; raises ValueError '''
    if profile is not None and (
            profile.device != device or profile.dtype != torch.int64
            or tuple(profile.shape) != (len(PROFILE_PHASES),)
            or not profile.is_contiguous()):
        raise ValueError('%s: profile must be a contiguous int64 tensor of '
                         'shape (%d,) on %s'
                         % (what, len(PROFILE_PHASES), device))


def score_candidates(codes, rl, state, maxerrors, minoverlap, idx=None,
                     count=None, rows=None, profile=None):
    '''
    exact scoring of rows of one batch: ``(basecount [5, G], seqhits
    [T+1], seqbasehits [T+1])``, int64 -- kvarq_tpu's ``score_full`` over
    the rows (its ``score_gathered`` when they are the candidates).

    :param codes: uint8 ``[B, Lpad]`` read codes
    :param rl: int32 ``[B]`` read lengths (0 for padding rows)
    :param idx: int32 ``[n]`` batch rows to score (None: every row)
    :param count: int32 tensor of one element on the device of ``codes``:
        score ``idx[:count]`` (None: all of ``idx``)
    :param rows: reads per pass of the plain version
    :param profile: int64 ``[8]`` tensor on the card, or None: the
        kernel adds each warpgroup's clock cycles per phase to it
        (:py:data:`PROFILE_PHASES`)

    On a CPU tensor this is :py:func:`score_candidates_ref`.  On a CUDA
    tensor it launches csrc/score_step.cu (S1) on the current stream, or
    raises; the count is read on the card, never on the host, and the
    kernel's grid (one block per SM) does not depend on it.
    ``score_candidates.launches`` counts those launches.
    '''
    _check_args('score_candidates', codes, rl, state, idx, count)
    if codes.device.type == 'cpu':
        return score_candidates_ref(codes, rl, state, maxerrors, minoverlap,
                                    idx, count, rows)
    if codes.device.type != 'cuda':
        raise ValueError('score_candidates: unsupported device %s'
                         % codes.device)
    B, Lpad = codes.shape
    if Lpad % 4 or codes.data_ptr() % 4 or state.bank.numel() % 4:
        raise ValueError('score_candidates: Lpad, the codes pointer and the '
                         'bank length must be multiples of 4')
    _check_profile('score_candidates', profile, codes.device)
    G, T = state.G, state.T
    # one buffer, one memset
    out = torch.zeros(encode.NBASE * G + 2 * (T + 1), dtype=torch.int64,
                      device=codes.device)
    bc, sh, sbh = out.split([encode.NBASE * G, T + 1, T + 1])
    cap = B if idx is None else len(idx)
    if cap == 0:
        return bc.view(encode.NBASE, G), sh, sbh
    with torch.cuda.device(codes.device):
        err = _score_lib()(
            codes.data_ptr(), rl.data_ptr(),
            None if idx is None else idx.data_ptr(),
            None if count is None else count.data_ptr(), cap,
            state.bank.data_ptr(), state.bank.numel() // 4,
            state.onehot.data_ptr(), state.onehot.shape[1],
            state.sterms.data_ptr(), state.qmeta.data_ptr(),
            state.tseg.data_ptr(), bc.data_ptr(),
            sh.data_ptr(), sbh.data_ptr(), Lpad, state.Qp, G, state.nch,
            maxerrors, minoverlap,
            None if profile is None else profile.data_ptr(),
            torch.cuda.current_stream(codes.device).cuda_stream)
    if err:
        raise RuntimeError('score_step kernel launch failed: CUDA error %d'
                           % err)
    score_candidates.launches += 1
    return bc.view(encode.NBASE, G), sh, sbh


score_candidates.launches = 0

# the entries of the profile buffer of score_candidates and hit_triplets
# (PROF_* of csrc/kvq_s1_pipeline.h), clock64() cycles summed over
# warpgroups
PROFILE_PHASES = ('build', 'mma', 'screen', 'drain', 'wait', 'total',
                  'stage', 'stage_wait')


# --- exact hit extraction -----------------------------------------------------

# the triplet buffer's capacity when the caller gives none
HIT_CAP = 4096


def _hit_buffer(cap, device):
    ''' the triplet buffer ``[cap, 3]`` and its counter, views of one int32
        storage with the counter first (:py:func:`triplets_to_host` copies
        both at once); the counter is zero, the buffer not cleared '''
    flat = torch.empty(1 + 3 * cap, dtype=torch.int32, device=device)
    flat[:1].zero_()      # a fill on the card (item assignment would copy)
    return flat[1:].view(cap, 3), flat[0]


def triplets_to_host(buf, n):
    ''' ``(triplets, count)``: the first ``min(count, cap)`` rows of the
        buffer as an int64 ``[m, 3]`` numpy array and the count, from the
        views :py:func:`hit_triplets` returns, in one copy to the host (one
        wait on the card) '''
    cap = buf.shape[0]
    host = buf.as_strided((1 + 3 * cap,), (1,), n.storage_offset()).cpu() \
        .numpy()
    count = int(host[0])
    m = min(count, cap)
    return host[1:1 + 3 * m].reshape(m, 3).astype(np.int64), count


def _check_hit_args(codes, rl, state, idx, count, row_ids, cap):
    ''' :py:func:`_check_args` and the extraction's own arguments '''
    _check_args('hit_triplets', codes, rl, state, idx, count)
    B = codes.shape[0]
    if row_ids is not None and (
            row_ids.device != codes.device or row_ids.dtype != torch.int32
            or tuple(row_ids.shape) != (B,) or not row_ids.is_contiguous()):
        raise ValueError(
            'hit_triplets: row_ids must be a contiguous int32 tensor of shape '
            '%s on %s (got %s %s on %s)' % ((B,), codes.device, row_ids.dtype,
                                            tuple(row_ids.shape),
                                            row_ids.device))
    if cap is not None and not 0 <= cap < 1 << 29:
        raise ValueError('hit_triplets: cap %r out of range' % (cap,))


def hit_triplets_ref(codes, rl, state, maxerrors, minoverlap, idx=None,
                     count=None, row_ids=None, cap=HIT_CAP, rows=None):
    ''' plain PyTorch version of :py:func:`hit_triplets`: the rows
        ``idx[:count]`` (every row when ``idx`` is None) as kvarq_tpu's
        ``XlaMatcher`` extracts them: the match product, ``mode_weights``
        over ``[rows, Qp]``, ``w > 0`` and ``torch.nonzero``, in passes of
        ``rows`` reads (None: all at once).  It reads the count on the
        host.  ``cap`` None sizes the buffer to the triplets. '''
    _check_hit_args(codes, rl, state, idx, count, row_ids, cap)
    from kvarq_tpu_torch.engine.tensor_scan import mode_weights
    sel = torch.arange(codes.shape[0], device=codes.device)
    if idx is not None:
        n = len(idx) if count is None else max(0, min(int(count), len(idx)))
        sel = idx[:n].long()
    qm = state.qmeta
    rows = rows or max(1, len(sel))
    out = []
    for s in range(0, len(sel), rows):
        b = sel[s:s + rows]
        m = match_counts(codes[b], state.K, state.nch)
        w, _ = mode_weights(m, rl[b, None], qm[ROW_D:ROW_D + 1],
                            qm[ROW_SEQL:ROW_SEQL + 1],
                            qm[ROW_VALID:ROW_VALID + 1], maxerrors,
                            minoverlap)
        del m
        r, q = torch.nonzero(w > 0, as_tuple=True)
        del w
        b = b[r]
        out.append(torch.stack([
            b if row_ids is None else row_ids[b].long(),
            state.tseg[q].long(), qm[ROW_D][q].long()], dim=1))
    tri = torch.cat(out) if out else torch.zeros((0, 3), dtype=torch.int64,
                                                 device=codes.device)
    n = len(tri)
    buf, cnt = _hit_buffer(n if cap is None else cap, codes.device)
    m = min(n, buf.shape[0])
    buf[:m] = tri[:m].to(torch.int32)
    cnt.fill_(n)
    return buf, cnt


def _hit_lib():
    lib = native_cuda.load('score_step.cu')
    fn = lib.kvq_hit_extract
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, i, vp, i, vp, ctypes.c_long, vp, vp,
                       vp, vp, vp, vp, i, i, i, i, i, i, vp, vp]
        fn.restype = ctypes.c_int
    return fn


def hit_triplets(codes, rl, state, maxerrors, minoverlap, idx=None,
                 count=None, row_ids=None, cap=HIT_CAP, profile=None):
    '''
    exact hit extraction of rows of one batch: every ``(row, template,
    shift)`` of a row and a shift column ``q`` with a hit-mode weight
    above 0 (kvarq_tpu's ``XlaMatcher`` triplets), as ``(row_ids[b],
    tseg[q], qmeta[ROW_D, q])``, in no particular order.

    :param codes: uint8 ``[B, Lpad]`` read codes
    :param rl: int32 ``[B]`` read lengths (0 for padding rows)
    :param idx: int32 ``[n]`` batch rows to extract (None: every row)
    :param count: int32 tensor of one element on the device of ``codes``:
        extract ``idx[:count]`` (None: all of ``idx``)
    :param row_ids: int32 ``[B]`` on the device of ``codes``: the id a
        triplet reports for batch row ``b`` (None: ``b``)
    :param cap: the triplet buffer's capacity
    :param profile: int64 ``[8]`` tensor on the card, or None: the
        kernel adds each warpgroup's clock cycles per phase to it
        (:py:data:`PROFILE_PHASES`)
    :returns: ``(buffer, n)`` -- int32 ``[cap, 3]`` whose first ``min(n,
        cap)`` rows are triplets, and ``n``, the number of triplets (it
        may exceed ``cap``), a 0-d int32 tensor on the device of
        ``codes``; views of one storage (:py:func:`triplets_to_host`)

    On a CPU tensor this is :py:func:`hit_triplets_ref`.  On a CUDA tensor
    it launches H1 (csrc/score_step.cu ``kvq_hit_extract``) on the current
    stream, or raises; the count is read on the card, never on the host,
    and the kernel's grid (one block per SM) does not depend on it.
    ``hit_triplets.launches`` counts those launches.
    '''
    _check_hit_args(codes, rl, state, idx, count, row_ids, cap)
    if codes.device.type == 'cpu':
        return hit_triplets_ref(codes, rl, state, maxerrors, minoverlap, idx,
                                count, row_ids, cap)
    if codes.device.type != 'cuda':
        raise ValueError('hit_triplets: unsupported device %s' % codes.device)
    if cap is None:
        raise ValueError('hit_triplets: the card needs a cap')
    B, Lpad = codes.shape
    if Lpad % 4 or codes.data_ptr() % 4 or state.bank.numel() % 4:
        raise ValueError('hit_triplets: Lpad, the codes pointer and the bank '
                         'length must be multiples of 4')
    _check_profile('hit_triplets', profile, codes.device)
    buf, n = _hit_buffer(cap, codes.device)
    rank = B if idx is None else len(idx)
    if rank == 0:
        return buf, n
    with torch.cuda.device(codes.device):
        err = _hit_lib()(
            codes.data_ptr(), rl.data_ptr(),
            None if idx is None else idx.data_ptr(),
            None if count is None else count.data_ptr(), rank,
            state.bank.data_ptr(), state.bank.numel() // 4,
            state.onehot.data_ptr(), state.onehot.shape[1],
            state.sterms.data_ptr(), state.qmeta.data_ptr(),
            state.tseg.data_ptr(),
            None if row_ids is None else row_ids.data_ptr(),
            buf.data_ptr(), n.data_ptr(), cap, Lpad, state.Qp, state.nch,
            maxerrors, minoverlap,
            None if profile is None else profile.data_ptr(),
            torch.cuda.current_stream(codes.device).cuda_stream)
    if err:
        raise RuntimeError('hit_extract kernel launch failed: CUDA error %d'
                           % err)
    hit_triplets.launches += 1
    return buf, n


hit_triplets.launches = 0


def compact(mask, size=None):
    ''' compaction on the device of ``mask`` with no host sync: ``(idx,
        count)`` -- ``idx [size]`` int32 holds the indices of the set
        entries in order and 0 past them (``jnp.nonzero(mask, size=size,
        fill_value=0)``), ``count`` the number of set entries, a 0-d int32
        tensor that may exceed ``size``.  ``size`` defaults to
        ``len(mask)``.  A prefix sum, then a scatter with a dump slot. '''
    n = mask.shape[0]
    size = n if size is None else size
    dev = mask.device
    csum = torch.cumsum(mask, 0, dtype=torch.int32)
    count = csum[-1] if n else torch.zeros((), dtype=torch.int32, device=dev)
    pos = torch.where(mask & (csum <= size), csum - 1, size)
    idx = torch.zeros(size + 1, dtype=torch.int32, device=dev)
    idx.scatter_(0, pos.long(), torch.arange(n, dtype=torch.int32, device=dev))
    return idx[:size], count


def scan_step_banked(codes, rl, state, maxerrors, minoverlap, screen,
                     rows=None):
    '''
    one scan step over ``codes [B, Lpad] uint8``, ``rl [B] int32``:
    :returns: ``(basecount [5, G], seqhits [T+1], seqbasehits [T+1],
        count)`` -- int64 tensors, and the number of candidate reads (0
        when the step does not screen) as a 0-d int32 tensor on the device
        of ``codes``, which TensorScanner reads to decide when to turn
        dense.  ``rows`` bounds the reads per pass of the plain scoring
        (:py:func:`score_candidates`).

    Without ``screen`` every read is scored.  With it the candidate screen
    flags reads, they are compacted on the device (:py:func:`compact`) and
    scored exactly, however many flag (the scoring kernel's grid does not
    depend on the count), which equals kvarq_tpu's full-batch fallback (a
    read the screen does not flag scores nothing).  On a CUDA tensor
    nothing here reads a device value on the host, and nothing of size
    ``[B, Qp]`` is allocated.
    '''
    if not screen:
        count = torch.zeros((), dtype=torch.int32, device=codes.device)
        return (*score_candidates(codes, rl, state, maxerrors, minoverlap,
                                  rows=rows), count)
    hit = cand_counts(codes, rl, state, maxerrors, minoverlap, state.nch) > 0
    idx, count = compact(hit)
    return (*score_candidates(codes, rl, state, maxerrors, minoverlap, idx,
                              count, rows), count)
