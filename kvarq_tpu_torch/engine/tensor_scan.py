'''
Scan driver of the port (counterpart of kvarq_tpu/engine/tensor_scan.py):
the mode gating :py:func:`mode_weights`, the accumulating single-device
:py:class:`TensorScanner` with its screen-or-dense rule :py:func:`screens`,
and a copy of kvarq_tpu's numpy helper :py:func:`build_bank`.  kvarq_tpu's
``fold_into_coverage`` (base counts into a
:py:class:`~kvarq_tpu_torch.analyse.Coverage`) is the port's
:py:func:`kvarq_tpu_torch.engine.encode.fold_into_coverage`, in a module
without torch, so that a scan on the host's numpy matcher never imports
torch.
'''

import numpy as np
import torch

from kvarq_tpu_torch import profiling
from kvarq_tpu_torch.engine import encode, pallas_scan
from kvarq_tpu_torch.log import lo


def build_bank(seqs, Lpad, minoverlap=None):
    # imported here: match_xla imports this module
    from kvarq_tpu_torch.engine.match_xla import _Bank
    return _Bank(seqs, Lpad, minoverlap)


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


def screens(scanner, rows):
    ''' the scan's one screen-or-dense rule: a step of ``rows`` reads
        screens (candidate screen, compaction, exact scoring of the
        candidates) iff ``scanner`` is not dense and ``rows`` is above its
        ``SCREEN_MIN_ROWS``; otherwise every row is scored.  Both give the
        same counts. '''
    return not scanner.dense and rows > scanner.SCREEN_MIN_ROWS


class TensorScanner:
    ''' single-device scan driver: accumulates bank-position base counts
        and per-template stats over many batches.

        On the card a step is the whole batch: the candidate screen K1
        and the exact scoring S1 of the candidates, one launch each, or S1
        alone over every row (:py:func:`screens`), with no host round
        trip; the candidate count stays on the card (its maximum over the
        steps, ``torch.maximum``).  On the CPU the plain screen and scoring
        materialise ``[B, Qp]``, so the step itself is :py:func:`score_rows`
        reads.  Accumulators live on the device in int64 (exact at any step
        size) and are flushed into the host totals, the candidate maximum
        with them in one transfer, every :py:data:`FLUSH_STEPS` steps.

        A step of at most :py:data:`SCREEN_MIN_ROWS` reads is scored
        whole.  The scan turns ``dense`` for good (every later step scored
        whole) when a candidate count reaches :py:data:`DENSE_AT`: read at
        the first screened step of each context (a hit-dense input turns
        at once) and at each flush.  :py:meth:`assume_dense` starts it
        dense.

        Inside :py:func:`kvarq_tpu_torch.profiling.recording` a step
        records the span ``engine.copy`` (the copies of its codes and
        lengths to the device) and the counters ``scan.h2d_bytes`` (their
        bytes), ``scan.screened`` (reads with a length above 0 that the
        screen takes) and ``scan.scored`` (rows the exact scoring takes:
        the step's rows when it does not screen, the compacted candidates
        when it does, summed on the device and read with the flush's
        transfer). '''

    FLUSH_STEPS = 64
    # the values at which the JAX package's gather_k ladder acted: its
    # first bucket, and the least candidate maximum c with
    # c + 8 sqrt(c) + 64 above its last bucket, 6144
    SCREEN_MIN_ROWS = 768
    DENSE_AT = 5488
    dense = False

    def __init__(self, seqs, maxerrors, minoverlap, device):
        self.seqs = list(seqs)
        self.maxerrors = maxerrors
        self.minoverlap = minoverlap
        self.T = len(self.seqs)
        self.device = torch.device(device)
        self._ctx = {}
        self.reset()

    def assume_dense(self):
        ''' sieve-fed input is candidate-dense: start dense instead of
            discovering it.  No-op once a context exists. '''
        if not self._ctx:
            self.dense = True

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

    def _observe(self, candmax):
        ''' turn dense for good at a candidate maximum of DENSE_AT.  The
            accumulators are exact in either mode, so nothing is flushed. '''
        if not self.dense and candmax >= self.DENSE_AT:
            lo.info('scoring every row from here (observed %d candidates '
                    'a step)' % candmax)
            self.dense = True

    def _step(self, Lpad, codes, rl):
        ctx = self._ctx[Lpad]
        codes = np.ascontiguousarray(codes)
        rl = np.ascontiguousarray(rl, np.int32)
        with profiling.span('engine.copy'):
            codes_d = torch.from_numpy(codes).to(self.device,
                                                 non_blocking=True)
            rl_d = torch.from_numpy(rl).to(self.device, non_blocking=True)
        screen = screens(self, len(rl))
        bc, sh, sbh, count = pallas_scan.scan_step_banked(
            codes_d, rl_d, ctx['state'], self.maxerrors, self.minoverlap,
            screen, ctx['rows'])
        # the rows scored after the screen stay on the device until the
        # flush; None while not recording
        scored = None
        if profiling.is_recording():
            profiling.count('scan.h2d_bytes', codes.nbytes + rl.nbytes)
            if screen:
                profiling.count('scan.screened', int(np.count_nonzero(rl)))
                scored = count.long()
            else:
                profiling.count('scan.scored', len(rl))
        if ctx['acc'] is None:
            ctx['acc'] = [bc, sh, sbh, count, scored]
        else:
            acc = ctx['acc']
            for a, d in zip(acc, (bc, sh, sbh)):
                a += d
            acc[3] = torch.maximum(acc[3], count)
            if scored is not None:
                acc[4] = scored if acc[4] is None else acc[4] + scored
        ctx['steps'] += 1
        if screen and not ctx['peeked']:
            # a hit-dense input shows at its first screened step: one
            # scalar read back per context, rather than screening it until
            # the flush
            ctx['peeked'] = True
            self._observe(int(count))
        if ctx['steps'] >= self.FLUSH_STEPS:
            self._flush(Lpad)

    def _flush(self, Lpad):
        ''' move the device accumulators into the host totals '''
        ctx = self._ctx[Lpad]
        if ctx['acc'] is None:
            return
        bc, sh, sbh, cm, scored = ctx['acc']
        # one transfer: the accumulators, the candidate maximum and, while
        # recording, the rows scored after the screen
        parts = [bc.flatten(), sh, sbh, cm.view(1).long()]
        if scored is not None:
            parts.append(scored.view(1))
        flat = torch.cat(parts).cpu().numpy()
        if scored is not None:
            profiling.count('scan.scored', int(flat[-1]))
            flat = flat[:-1]
        host = self.basecounts.setdefault(
            Lpad, np.zeros((encode.NBASE, ctx['bank'].G), dtype=np.int64))
        nbc = bc.numel()
        host += flat[:nbc].reshape(host.shape)
        self.seqhits += flat[nbc:nbc + self.T]
        self.seqbasehits += flat[nbc + self.T + 1:nbc + 2 * self.T + 1]
        ctx.update(acc=None, steps=0)
        self._observe(int(flat[-1]))

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
