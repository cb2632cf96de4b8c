'''
Exact hit extraction of the port (counterpart of
kvarq_tpu/engine/match_xla.py ``XlaMatcher``, device item X4): every
passing ``(read, template, shift)`` triplet of a batch.

It builds on the scanner's own bank state
(:py:func:`kvarq_tpu_torch.engine.pallas_scan.device_arrays` of a
:py:class:`_Bank` with minoverlap gaps, the concatenated template bank of
kvarq_tpu's module, copied here), so a shift column ``q`` carries its
template in ``tseg[q]`` and its shift in ``qmeta[ROW_D, q]``.

On a CUDA tensor :py:func:`extract` launches the kernel H1
(:py:func:`~kvarq_tpu_torch.engine.pallas_scan.hit_triplets`), which
writes only the passing triplets into a buffer of a capacity the matcher
keeps, and reads the buffer and its count back in one copy: one wait on
the card per batch, nothing of size ``[rows, Qp]``.  A count above the
capacity scores the batch again at the next power of two at or above
it, and the matcher keeps the larger capacity.  On a CPU tensor it is
the plain version
(:py:func:`~kvarq_tpu_torch.engine.pallas_scan.hit_triplets_ref`: the
match product, ``tensor_scan.mode_weights``, ``w > 0`` and
``torch.nonzero``) in passes of :py:func:`~kvarq_tpu_torch.engine.tensor_scan.score_rows`
reads, which bounds its ``[rows, Qp]`` temporaries.

The JAX package's TPU workarounds (the 512-wide window, the ``pack16``
f32 bit-packing, the wide-row gather and the fixed element budget) have
no counterpart.
'''

import numpy as np
import torch

from kvarq_tpu_torch.engine import encode, pallas_scan
from kvarq_tpu_torch.engine.tensor_scan import score_rows


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


def read_triplets(codes, rl, state, maxerrors, minoverlap, idx=None,
                  count=None, row_ids=None, cap=pallas_scan.HIT_CAP):
    ''' :py:func:`~kvarq_tpu_torch.engine.pallas_scan.hit_triplets` (H1
        on a CUDA tensor) and one readback of the buffer with its count;
        a count above ``cap`` scores the rows again at the next power of
        two at or above it.  :returns: ``(triplets, cap)`` -- the int64
        ``[n, 3]`` numpy triplets and the capacity that held them '''
    while True:
        buf, n = pallas_scan.hit_triplets(codes, rl, state, maxerrors,
                                          minoverlap, idx, count, row_ids,
                                          cap)
        tri, n = pallas_scan.triplets_to_host(buf, n)
        if n <= cap:
            return tri, cap
        cap = 1 << (n - 1).bit_length()


def extract(codes, rl, state, maxerrors, minoverlap, rows=None,
            row_ids=None, idx=None, count=None, cap=pallas_scan.HIT_CAP):
    '''
    passing triplets of ``codes [B, Lpad] uint8``, ``rl [B] int32``
    (device tensors; ``rl == 0`` rows never pass).

    :param rows: reads per pass of the plain version (None: all at once)
    :param row_ids: int32 ``[B]`` device tensor mapping batch row ``b`` to
        the row reported for it (None: ``b`` itself)
    :param idx: int32 ``[n]`` device tensor of the batch rows to extract
        (None: every row); ``count``, a one-element int32 tensor on the
        device: ``idx[:count]`` only (None: all of ``idx``)
    :param cap: the card's first triplet capacity (:py:func:`read_triplets`)
    :returns: int64 ``[n, 3]`` numpy array of ``(b, template, d)``, in
        no particular order
    '''
    if codes.device.type == 'cuda':
        return read_triplets(codes, rl, state, maxerrors, minoverlap, idx,
                             count, row_ids, cap)[0]
    buf, _ = pallas_scan.hit_triplets_ref(codes, rl, state, maxerrors,
                                          minoverlap, idx, count, row_ids,
                                          None, rows)
    return buf.numpy().astype(np.int64)


class XlaMatcher:

    ''' exact extraction of every read of a batch; per read padding
        ``Lpad`` one bank state on ``device`` '''

    def __init__(self, seqs, maxerrors, minoverlap, device):
        self.seqs = list(seqs)
        self.maxerrors = maxerrors
        self.minoverlap = minoverlap
        self.device = torch.device(device)
        self._ctx = {}
        # the card's triplet capacity: it only grows
        self.cap = pallas_scan.HIT_CAP

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
        ''' the batch's ``codes`` and int32 ``rl`` on the device (no wait
            on the card) '''
        codes = torch.from_numpy(np.ascontiguousarray(batch.codes)).to(
            self.device, non_blocking=True)
        rl = torch.from_numpy(np.ascontiguousarray(batch.rl, np.int32)).to(
            self.device, non_blocking=True)
        return codes, rl

    def extract(self, codes, rl, idx=None, count=None):
        ''' :py:func:`extract` of the rows ``idx[:count]`` of a batch on
            the device, at this matcher's capacity (grown where a batch
            overflows it) '''
        state, rows = self.context(codes.shape[1])
        if codes.device.type == 'cuda':
            tri, self.cap = read_triplets(codes, rl, state, self.maxerrors,
                                          self.minoverlap, idx, count,
                                          cap=self.cap)
            return tri
        return extract(codes, rl, state, self.maxerrors, self.minoverlap,
                       rows, idx=idx, count=count)

    def match_batch(self, batch):
        ''' :returns: int64 ``[n, 3]`` ``(b, template, d)`` triplets '''
        return self.extract(*self.to_device(batch))
