'''
Scan driver of the port (counterpart of kvarq_tpu/engine/tensor_scan.py):
the mode gating :py:func:`mode_weights`, the accumulating single-device
:py:class:`TensorScanner`, and copies of kvarq_tpu's numpy helpers
:py:func:`build_bank` and :py:func:`default_gather_k`.  kvarq_tpu's
``fold_into_coverage`` (base counts into a
:py:class:`~kvarq_tpu_torch.analyse.Coverage`) is the port's
:py:func:`kvarq_tpu_torch.engine.encode.fold_into_coverage`, in a module
without torch, so that a scan on the host's numpy matcher never imports
torch.
'''

import os

import numpy as np
import torch

from kvarq_tpu_torch.engine import encode, pallas_scan
from kvarq_tpu_torch.log import lo


def build_bank(seqs, Lpad, minoverlap=None):
    # imported here: match_xla imports this module
    from kvarq_tpu_torch.engine.match_xla import _Bank
    return _Bank(seqs, Lpad, minoverlap)


def default_gather_k():
    ''' resolve $KVARQ_GATHER_K: an explicit integer pins the compacted
        exact-scoring width; ``auto`` (the default) starts at 768 (the JAX
        package's value, tuned on its TPU) and lets TensorScanner adapt
        upward when the observed candidate count overflows it '''
    v = os.environ.get('KVARQ_GATHER_K', 'auto').strip().lower()
    if v in ('', 'auto'):
        return 768, True
    if v in ('0', 'off', 'dense'):
        return 0, False          # dense mode: no screen, exact full pass
    return int(v), False


def mode_weights(matches, rl_col, d_row, seql_row, valid_row,
                 maxerrors, minoverlap):
    '''
    mode gating: given match counts ``[B, Q]`` (any dtype holding exact
    integers), an int read-length column ``[B, 1]`` and int per-column
    rows ``[1, Q]``, return int32 ``(w, ov)`` -- the hit-mode weight
    (0/1/2, incl. the mode-B/D border duplicate) and the overlap length
    per (read, shift).  The reduced closed form of the four-mode
    enumeration (kvarq_tpu.engine.hitmodel), in float32 like the JAX
    package: every quantity is an integer < 2^21, exact in f32.
    '''
    f32 = torch.float32
    d = d_row.to(f32)
    seql = seql_row.to(f32)
    rl_ = rl_col.to(f32)
    mo = float(minoverlap)

    t1 = d + rl_
    ov = torch.minimum(seql, t1) - torch.clamp(d, min=0.)
    mism = ov - matches.to(f32)

    ab = (rl_ > mo) & (seql > mo)
    govmo = ov >= mo
    wA = ab & (d < 0) & govmo & (ov != seql)
    wB = ab & (d > 0) & govmo & (t1 >= seql)
    full = ov == torch.minimum(rl_, seql)

    passing = (valid_row > 0) & (rl_ > 0) & (mism <= maxerrors)
    nmodes = wA.to(f32) + wB.to(f32) + full.to(f32)
    w = torch.where(passing, nmodes, 0.)
    return w.to(torch.int32), ov.to(torch.int32)


# reads per exact-scoring pass on the CPU: a bound in [B, Q] elements (as
# the JAX XLA path)
ELEM_BUDGET = 96 * 1024 * 1024
# on the card: device bytes per [B, Qp] element of the plain scoring's
# temporaries (match counts, mode_weights' f32 and bool intermediates, w
# and ov; 23.75 GB at 16384 x 40064 on an H100), and the share of the
# card's memory they may take.  The scan's own scoring and the hit path's
# extraction on the card are the kernels S1 and H1, which hold no [B, Qp]
# tensor: these size the passes of their plain versions
# (pallas_scan.score_candidates_ref, hit_triplets_ref).
SCORE_BYTES_PER_ELEM = 36
SCORE_MEM_SHARE = 0.5


def score_rows(device, Qp):
    ''' reads per exact-scoring pass at ``Qp`` shift columns.  On the card
        it is sized from the card's memory, not from what is free at the
        moment, so it does not move with the allocator's state. '''
    device = torch.device(device)
    if device.type != 'cuda':
        return max(64, min(8192, ELEM_BUDGET // max(Qp, 1)))
    total = torch.cuda.get_device_properties(device).total_memory
    fit = int(total * SCORE_MEM_SHARE) // (SCORE_BYTES_PER_ELEM * Qp)
    return max(512, fit // 512 * 512)


class TensorScanner:
    ''' single-device scan driver: accumulates bank-position base counts
        and per-template stats over many batches.

        On the card a step is the whole batch: the candidate screen K1
        (gathered mode) and the exact scoring S1, one launch each, with no
        host round trip; the candidate count stays on the card (its
        maximum over the steps, ``torch.maximum``).  On the CPU the plain
        screen and scoring materialise ``[B, Qp]``, so the step itself is
        :py:func:`score_rows` reads.  Accumulators live on the device in
        int64 (exact at any step size) and are flushed into the host
        totals, the candidate maximum with them in one transfer, every
        :py:data:`FLUSH_STEPS` steps; besides, the first step of each
        context reads its count once (a hit-dense input adapts at once).
        ``gather_k`` follows the JAX package's adaptive policy: start at
        768 (``$KVARQ_GATHER_K``), grow over :py:data:`GATHER_BUCKETS`
        when the observed candidate count overflows, terminal dense mode
        past the last bucket. '''

    FLUSH_STEPS = 64
    GATHER_BUCKETS = (768, 1536, 3072, 6144)

    def __init__(self, seqs, maxerrors, minoverlap, device):
        self.seqs = list(seqs)
        self.maxerrors = maxerrors
        self.minoverlap = minoverlap
        self.T = len(self.seqs)
        self.device = torch.device(device)
        self.gather_k, self._gather_auto = default_gather_k()
        self._ctx = {}
        self.reset()

    def assume_dense(self):
        ''' sieve-fed input is candidate-dense: start in dense mode instead
            of discovering it on the first step.  No-op when gather_k was
            pinned explicitly or a context exists already. '''
        if self._gather_auto and not self._ctx:
            self.gather_k = 0

    def reset(self):
        self.basecounts = {}   # Lpad -> accumulated [5, G] host int64
        self.seqhits = np.zeros(self.T, dtype=np.int64)
        self.seqbasehits = np.zeros(self.T, dtype=np.int64)
        for ctx in self._ctx.values():
            ctx.update(acc=None, steps=0)

    def _context(self, Lpad):
        if Lpad not in self._ctx:
            bank = build_bank(self.seqs, Lpad, self.minoverlap)
            state = pallas_scan.device_arrays(bank, self.T, self.device)
            self._ctx[Lpad] = dict(
                bank=bank, state=state,
                rows=score_rows(self.device, state.Qp),
                acc=None, steps=0, peeked=False)
            lo.debug('Lpad %d: bank G=%d Qp=%d nch=%d, %d reads per scoring '
                     'pass' % (Lpad, state.G, state.Qp, state.nch,
                               self._ctx[Lpad]['rows']))
        return self._ctx[Lpad]

    def _adapt_gather(self, Lpad, candmax):
        ''' grow gather_k when the observed per-step candidate count
            overflows it (auto mode); returns True when it changed.  The
            bank state does not depend on gather_k, so every context is
            kept and only its accumulators are flushed first. '''
        if not self._gather_auto or self.gather_k == 0:
            return False         # pinned, or dense mode (terminal)
        want = int(candmax + 8 * np.sqrt(max(candmax, 1)) + 64)
        if want <= self.gather_k:
            return False
        new = next((b for b in self.GATHER_BUCKETS if b >= want), 0)
        if new and new <= self.gather_k:
            return False
        lo.info('gather_k %d -> %s (observed %d candidates/step)'
                % (self.gather_k, new if new else 'dense', candmax))
        self.gather_k = new
        for lp in list(self._ctx):
            self._flush(lp, adapt=False)
        return True

    def _step(self, Lpad, codes, rl):
        ctx = self._ctx[Lpad]
        codes = torch.from_numpy(np.ascontiguousarray(codes)).to(
            self.device, non_blocking=True)
        rl = torch.from_numpy(np.ascontiguousarray(rl, np.int32)).to(
            self.device, non_blocking=True)
        bc, sh, sbh, count = pallas_scan.scan_step_banked(
            codes, rl, ctx['state'], self.maxerrors, self.minoverlap,
            self.gather_k, ctx['rows'])
        if ctx['acc'] is None:
            ctx['acc'] = [bc, sh, sbh, count]
        else:
            for a, d in zip(ctx['acc'], (bc, sh, sbh)):
                a += d
            ctx['acc'][3] = torch.maximum(ctx['acc'][3], count)
        ctx['steps'] += 1
        if self._gather_auto and self.gather_k and not ctx['peeked']:
            # a hit-dense input overflows from its first step: adapt now
            # (one scalar read back per context) instead of scoring the
            # overflow until the flush
            ctx['peeked'] = True
            if self._adapt_gather(Lpad, int(count)):
                return
        if ctx['steps'] >= self.FLUSH_STEPS:
            self._flush(Lpad)

    def _flush(self, Lpad, adapt=True):
        ''' move the device accumulators into the host totals '''
        ctx = self._ctx[Lpad]
        if ctx['acc'] is None:
            return
        bc, sh, sbh, cm = ctx['acc']
        # one transfer: the accumulators and the candidate maximum
        flat = torch.cat([bc.flatten(), sh, sbh, cm.view(1).long()]) \
            .cpu().numpy()
        host = self.basecounts.setdefault(
            Lpad, np.zeros((encode.NBASE, ctx['bank'].G), dtype=np.int64))
        nbc = bc.numel()
        host += flat[:nbc].reshape(host.shape)
        self.seqhits += flat[nbc:nbc + self.T]
        self.seqbasehits += flat[nbc + self.T + 1:nbc + 2 * self.T + 1]
        candmax = int(flat[-1])
        ctx.update(acc=None, steps=0)
        if adapt:
            self._adapt_gather(Lpad, candmax)

    def finalize(self):
        ''' flush all device accumulators; must be called before reading
            ``seqhits``/``seqbasehits``/:py:meth:`coverages` '''
        for Lpad in list(self._ctx):
            self._flush(Lpad)

    def scan_batch(self, batch):
        B, Lpad = batch.codes.shape
        ctx = self._context(Lpad)
        if ctx['bank'].G == 0:
            return
        step = B if self.device.type == 'cuda' else ctx['rows']
        for lo_ in range(0, B, step):
            self._step(Lpad, batch.codes[lo_:lo_ + step],
                       batch.rl[lo_:lo_ + step])

    def coverages(self):
        '''
        :returns: list (per template, in ``seqs`` order) of int64
            base-count arrays [5, S] in template-local coordinates, summed
            over all processed batches
        '''
        self.finalize()
        per_template = [np.zeros((encode.NBASE, len(s)), dtype=np.int64)
                        for s in self.seqs]
        for Lpad, acc in self.basecounts.items():
            tstart = self._ctx[Lpad]['bank'].tstart
            for t, s in enumerate(self.seqs):
                pos = tstart[t]
                per_template[t] += acc[:, pos:pos + len(s)]
        return per_template
