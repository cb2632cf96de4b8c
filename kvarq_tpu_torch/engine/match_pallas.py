'''
Screening hit-list matcher of the port (counterpart of
kvarq_tpu/engine/match_pallas.py ``PallasMatcher``): the candidate screen
:py:func:`~kvarq_tpu_torch.engine.pallas_scan.cand_counts` flags the
reads of a whole batch (on a CUDA tensor the kernel
csrc/cand_screen.cu, the port of the TPU kernel ``_cand_kernel``), the
flagged rows are compacted on the device, and only those go through the
exact extraction of :py:mod:`kvarq_tpu_torch.engine.match_xla`.  The
candidates are a superset of the hitting reads, so the triplets equal
:py:class:`~kvarq_tpu_torch.engine.match_xla.XlaMatcher`'s.

The screen runs over the whole batch at the reader's own ``Lpad`` (every
bucket of ``kvarq_tpu.engine.reader._round_up`` is a multiple of 4, as
the kernel needs): the JAX package's re-padding to 128 only saved TPU
compiles.  The flagged count is synchronised to the host once per
batch, by ``torch.nonzero``.  The plain screen on a CPU tensor
materialises ``[B, Qp]``; the engine picks this matcher only on the
card.
'''

import torch

from kvarq_tpu_torch.engine import pallas_scan
from kvarq_tpu_torch.engine.match_xla import XlaMatcher, _empty, extract


class PallasMatcher:

    def __init__(self, seqs, maxerrors, minoverlap, device):
        self.xla = XlaMatcher(seqs, maxerrors, minoverlap, device)
        self.maxerrors = maxerrors
        self.minoverlap = minoverlap

    def match_batch(self, batch):
        ''' :returns: int64 ``[n, 3]`` ``(b, template, d)`` triplets '''
        state, rows = self.xla.context(batch.codes.shape[1])
        codes, rl = self.xla.to_device(batch)
        flags = pallas_scan.cand_counts(codes, rl, state, self.maxerrors,
                                        self.minoverlap, state.nch) > 0
        idx = torch.nonzero(flags).flatten()
        if not len(idx):
            return _empty()
        return extract(codes[idx], rl[idx], state, self.maxerrors,
                       self.minoverlap, rows, row_ids=idx)
