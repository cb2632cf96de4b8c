'''
Entry points of the port (counterpart of the repository's
``__graft_entry__.py``):

- :py:func:`entry` -- one scan step on the flagship workload (the full
  MTBC template bank against a batch of 512 reads): the screened step
  ``pallas_scan.scan_step_banked`` (candidate screen, compaction, exact
  scoring) on either device; the screen and the scoring are the
  hand-written kernels K1 and S1 on the card, with no host round trip,
  and their plain versions on the CPU.
- :py:func:`dryrun_multichip` -- one sharded scan step on a mesh of
  ``n_devices`` entries (:py:func:`kvarq_tpu_torch.parallel.dryrun`).

kvarq_tpu's ``XLA_FLAGS`` virtual devices and ``KVARQ_DRYRUN_REAL`` have
no counterpart: the CPU is reached with ``device='cpu'`` /
``backend='cpu'``.
'''

import numpy as np
import torch

from kvarq_tpu_torch import device as _device

LPAD = 128
B = 512
MINOVERLAP = 25
MAXERRORS = 2


def _mtbc_seqs():
    ''' plus+minus template bases of the full MTBC testsuites '''
    from kvarq_tpu_torch import bench
    from kvarq_tpu_torch.analyse import Analyser
    analyser = Analyser()
    coverages = analyser.load_coverages(bench.load_mtbc(),
                                        spacing=analyser.spacing)
    seqs = [c.plus_seq.bases for c in coverages.values()]
    seqs += [c.minus_seq.bases for c in coverages.values()]
    return seqs


def entry(device='cuda'):
    ''' :returns: ``(fn, example_args)`` -- ``fn(codes, rl)`` is the scan
        step over the MTBC bank (Lpad 128, minoverlap 25, 2 errors),
        returning int64 ``(basecount [5, G], seqhits [T+1], seqbasehits
        [T+1])``; ``example_args`` are 512 random reads on ``device``
        with template 0 planted in read 0 '''
    from kvarq_tpu_torch.engine import encode, pallas_scan, tensor_scan

    dev = _device.select(device)
    seqs = _mtbc_seqs()
    bank = tensor_scan.build_bank(seqs, LPAD, minoverlap=MINOVERLAP)
    state = pallas_scan.device_arrays(bank, len(seqs), dev)

    def fn(codes, rl):
        bc, sh, sbh, _ = pallas_scan.scan_step_banked(
            codes, rl, state, MAXERRORS, MINOVERLAP, screen=True)
        return bc, sh, sbh

    rng = np.random.RandomState(0)
    raw = rng.choice(np.frombuffer(b'ACGT', dtype=np.uint8), (B, LPAD))
    # plant one real template so the step produces nonzero output
    t0 = seqs[0].encode()
    raw[0, :len(t0)] = np.frombuffer(t0, dtype=np.uint8)[:LPAD]
    codes = torch.from_numpy(encode.encode_read_array(raw)).to(dev)
    rl = torch.full((B,), 101, dtype=torch.int32, device=dev)
    return fn, (codes, rl)


def dryrun_multichip(n_devices, backend='cuda'):
    ''' one sharded scan step on a mesh of ``n_devices`` entries of
        ``backend`` (the cards repeated when there are fewer) '''
    from kvarq_tpu_torch import parallel
    return parallel.dryrun(n_devices, backend)
