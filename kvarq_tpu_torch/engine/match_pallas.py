'''
Screening hit-list matcher of the port (counterpart of
kvarq_tpu/engine/match_pallas.py ``PallasMatcher``): the candidate screen
:py:func:`~kvarq_tpu_torch.engine.pallas_scan.cand_counts` flags the
reads of a whole batch (on a CUDA tensor the kernel
csrc/cand_screen.cu, the port of the TPU kernel ``_cand_kernel``), the
flagged rows are compacted on the device
(:py:func:`~kvarq_tpu_torch.engine.pallas_scan.compact`), and only those
go through the exact extraction of
:py:mod:`kvarq_tpu_torch.engine.match_xla` (on a CUDA tensor the kernel
H1, over ``idx[:count]`` with the count read on the card).  The
candidates are a superset of the hitting reads, so the triplets equal
:py:class:`~kvarq_tpu_torch.engine.match_xla.XlaMatcher`'s.

The screen runs over the whole batch at the reader's own ``Lpad`` (every
bucket of ``kvarq_tpu.engine.reader._round_up`` is a multiple of 4, as
the kernels need): the JAX package's re-padding to 128 only saved TPU
compiles.  On the card a batch waits on the host once, for the
triplets and their count in one copy.  The plain screen on a CPU tensor
materialises ``[B, Qp]``; the engine picks this matcher only on the
card.
'''

from kvarq_tpu_torch.engine import pallas_scan
from kvarq_tpu_torch.engine.match_xla import XlaMatcher


class PallasMatcher:

    def __init__(self, seqs, maxerrors, minoverlap, device):
        self.xla = XlaMatcher(seqs, maxerrors, minoverlap, device)
        self.maxerrors = maxerrors
        self.minoverlap = minoverlap

    def match_batch(self, batch):
        ''' :returns: int64 ``[n, 3]`` ``(b, template, d)`` triplets '''
        state, _ = self.xla.context(batch.codes.shape[1])
        codes, rl = self.xla.to_device(batch)
        flags = pallas_scan.cand_counts(codes, rl, state, self.maxerrors,
                                        self.minoverlap, state.nch) > 0
        idx, count = pallas_scan.compact(flags)
        return self.xla.extract(codes, rl, idx, count)
