'''
Exact hit extraction of the port (counterpart of
kvarq_tpu/engine/match_xla.py ``XlaMatcher``, device item X4): every
passing ``(read, template, shift)`` triplet of a batch.

It builds on the scanner's own bank state
(:py:func:`kvarq_tpu_torch.engine.pallas_scan.device_arrays` of a
:py:class:`_Bank` with minoverlap gaps, the concatenated template bank of
kvarq_tpu's module, copied here), so a shift column ``q`` carries its
template in ``tseg[q]`` and its shift in ``qmeta[ROW_D, q]``.  A pass is
the scanner's match product, :py:func:`mode_weights`, ``w > 0`` and
``torch.nonzero``; its triplets are copied to the host once.  Passes are
:py:func:`~kvarq_tpu_torch.engine.tensor_scan.score_rows` reads, which
bounds the ``[rows, Qp]`` temporaries by the device's memory.

The JAX package's TPU workarounds (the 512-wide window, the ``pack16``
f32 bit-packing, the wide-row gather and the fixed element budget) have
no counterpart: ``nonzero`` gives the pairs directly.
'''

import numpy as np
import torch

from kvarq_tpu_torch.engine import encode, pallas_scan
from kvarq_tpu_torch.engine.pallas_scan import ROW_D, ROW_SEQL, ROW_VALID
from kvarq_tpu_torch.engine.tensor_scan import mode_weights, score_rows


class _Bank:
    ''' concatenated template bank for a given read padding Lpad.

        Gap between templates: with ``minoverlap`` given, the mode gating
        (hitmodel) bounds any *passing* alignment's hang-off past either
        template end by ``rl - minoverlap`` (modes A/B) or ``rl - seql``
        (mode C full containment), so ``Lpad - min(minoverlap, S_left,
        S_right)`` never-matching bases fully isolate neighbors while
        shrinking the bank ~20% vs. the conservative ``Lpad`` clearance.
        Shift columns below the left-hang bound carry no tid and are
        gated out. '''

    def __init__(self, seqs, Lpad, minoverlap=None):
        self.Lpad = Lpad
        self.minoverlap = minoverlap
        codes = []
        tstart = []
        gaps = []
        pos = 0
        prev_S = None
        for s in seqs:
            if minoverlap is not None and minoverlap >= 1:
                clear = min(minoverlap, max(len(s), 1))
                if prev_S is not None:
                    clear = min(clear, max(prev_S, 1))
                gap = max(Lpad - clear, 0)
            else:
                gap = Lpad  # conservative clearance
            prev_S = len(s)
            gaps.append(gap)
            pos += gap
            tstart.append(pos)
            c = encode.encode_template(s)
            codes.append(np.full(gap, encode.CODE_TMPL_JUNK, dtype=np.uint8))
            codes.append(c)
            pos += len(c)
        self.codes = np.concatenate(codes) if codes else \
            np.zeros(0, dtype=np.uint8)
        self.G = len(self.codes)
        self.Q = self.G + Lpad - 1
        self.tstart = tstart

        # per-position maps: template id / shift d / template length; only
        # shifts that can pass the mode gating (d >= -gap) carry a tid, so
        # neighboring templates' ranges stay disjoint
        tid = np.full(self.Q, -1, dtype=np.int32)
        d_of = np.zeros(self.Q, dtype=np.int32)
        seql_of = np.ones(self.Q, dtype=np.int32)
        for t, (bs, gap, s) in enumerate(zip(tstart, gaps, seqs)):
            S = len(s)
            lowest = bs - gap          # leftmost passing read start
            highest = bs + S - 1
            qlo = lowest + (Lpad - 1)
            qhi = highest + (Lpad - 1)
            tid[qlo:qhi + 1] = t
            d_of[qlo:qhi + 1] = np.arange(lowest, highest + 1) - bs
            seql_of[qlo:qhi + 1] = S
        self.tid = tid
        self.d_of = d_of
        self.seql_of = seql_of


def _empty():
    return np.empty((0, 3), dtype=np.int64)


def extract(codes, rl, state, maxerrors, minoverlap, rows=None,
            row_ids=None):
    '''
    passing triplets of ``codes [B, Lpad] uint8``, ``rl [B] int32``
    (device tensors; ``rl == 0`` rows never pass).

    :param rows: reads per pass (None: all at once)
    :param row_ids: int64 ``[B]`` device tensor mapping row ``i`` to the
        batch row reported for it (None: ``i`` itself)
    :returns: int64 ``[n, 3]`` numpy array of ``(b, template, d)``, in
        no particular order
    '''
    B = codes.shape[0]
    qm = state.qmeta
    rows = rows or B
    out = []
    for s in range(0, B, rows):
        m = pallas_scan.match_counts(codes[s:s + rows], state.K, state.nch)
        w, _ = mode_weights(m, rl[s:s + rows, None], qm[ROW_D:ROW_D + 1],
                            qm[ROW_SEQL:ROW_SEQL + 1],
                            qm[ROW_VALID:ROW_VALID + 1], maxerrors,
                            minoverlap)
        del m
        b, q = torch.nonzero(w > 0, as_tuple=True)
        del w
        b = b + s if row_ids is None else row_ids[b + s]
        out.append(torch.stack([b, state.tseg[q].long(), qm[ROW_D][q].long()],
                               dim=1).cpu().numpy())
    return np.concatenate(out) if out else _empty()


class XlaMatcher:

    ''' exact extraction of every read of a batch; per read padding
        ``Lpad`` one bank state on ``device`` '''

    def __init__(self, seqs, maxerrors, minoverlap, device):
        self.seqs = list(seqs)
        self.maxerrors = maxerrors
        self.minoverlap = minoverlap
        self.device = torch.device(device)
        self._ctx = {}

    def context(self, Lpad):
        ''' :returns: ``(state, rows)`` -- the :py:class:`BankState` at
            ``Lpad`` and the reads per pass '''
        if Lpad not in self._ctx:
            state = pallas_scan.device_arrays(
                _Bank(self.seqs, Lpad, self.minoverlap), len(self.seqs),
                self.device)
            self._ctx[Lpad] = (state, score_rows(self.device, state.Qp))
        return self._ctx[Lpad]

    def to_device(self, batch):
        ''' the batch's ``codes`` and int32 ``rl`` on the device '''
        codes = torch.from_numpy(np.ascontiguousarray(batch.codes)).to(
            self.device)
        rl = torch.from_numpy(np.ascontiguousarray(batch.rl, np.int32)).to(
            self.device)
        return codes, rl

    def match_batch(self, batch):
        ''' :returns: int64 ``[n, 3]`` ``(b, template, d)`` triplets '''
        state, rows = self.context(batch.codes.shape[1])
        codes, rl = self.to_device(batch)
        return extract(codes, rl, state, self.maxerrors, self.minoverlap,
                       rows)
