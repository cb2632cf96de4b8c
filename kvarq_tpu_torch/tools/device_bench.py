#!/usr/bin/env python
'''
Device-sustained scan throughput of the port (counterpart of
tools/device_bench.py): the exhaustive (sieve-less) scan step over
batches that already sit on the device, apart from the host reader and
sieve.

Methodology: the MTBC bank (Lpad 128, 2 errors, minoverlap 25); batches
of ``--batch`` reads (16,384) of ``--readlen`` bases, ``--hitfrac`` of
them planted from template loci; up to 32 distinct batches (the JAX
tool's fused sub-batches) built on the host and uploaded once, then
``--batches`` steps of ``pallas_scan.scan_step_banked`` taking them in
turn, each screened where the scanner's rule screens a fresh scan's step
of that many reads (``tensor_scan.screens``: more than 768 reads), the
step results summed in int64 on the device and the candidate count kept
there (its maximum is read once, after the clock stops).  One
untimed warm-up step; ``torch.cuda.synchronize()`` before the clock
stops.  TOP/s counts the one-hot match product, ``2 * reads * Lpad * nch *
Qp``, as the JAX tool does.  kvarq_tpu's ``--fuse`` (dispatch fusing)
has no counterpart.

Usage:
    python -m kvarq_tpu_torch.tools.device_bench [--batches 256]
        [--hitfrac 0.03] [--readlen 101] [--device cpu]

The last line of the output is one JSON object with the numbers and the
device they were taken on.
'''

import argparse
import json
import sys
import time

import numpy as np
import torch

LPAD = 128
MAXERRORS = 2
MINOVERLAP = 25
SPACING = 25
DISTINCT = 32


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--batches', type=int, default=256,
                    help='timed steps (default 256: the JAX tool\'s 8 steps '
                         'of 32 fused batches)')
    ap.add_argument('--batch', type=int, default=16384,
                    help='reads per batch')
    ap.add_argument('--hitfrac', type=float, default=0.03,
                    help='fraction of reads planted from template loci')
    ap.add_argument('--readlen', type=int, default=101)
    ap.add_argument('--device', default='cuda', choices=('cuda', 'cpu'))
    args = ap.parse_args(argv)

    from kvarq_tpu_torch import bench, device
    from kvarq_tpu_torch.analyse import Analyser
    from kvarq_tpu_torch.engine import encode, pallas_scan, tensor_scan

    dev = device.select(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'
    covs = Analyser().load_coverages(bench.load_mtbc(), spacing=SPACING)
    seqs = [c.plus_seq.bases for c in covs.values()]
    seqs += [c.minus_seq.bases for c in covs.values()]

    t0 = time.time()
    bank = tensor_scan.build_bank(seqs, LPAD, MINOVERLAP)
    state = pallas_scan.device_arrays(bank, len(seqs), dev)
    rows = tensor_scan.score_rows(dev, state.Qp)
    screen = tensor_scan.screens(tensor_scan.TensorScanner, args.batch)
    print('bank G=%d Qp=%d nch=%d on %s in %.1fs; steps %s, plain '
          'scoring passes of <= %d reads' % (
              bank.G, state.Qp, state.nch, name, time.time() - t0,
              'screened' if screen else 'scored whole', rows),
          file=sys.stderr)

    # synthetic batches: mostly random reads, --hitfrac planted templates
    rng = np.random.RandomState(20260819)
    nb = min(args.batches, DISTINCT)
    bases = np.frombuffer(b'ACGT', dtype=np.uint8)
    raw = bases[rng.randint(4, size=(nb * args.batch, LPAD))]
    rl = np.full(nb * args.batch, args.readlen, dtype=np.int32)
    planted = np.flatnonzero(rng.rand(len(raw)) < args.hitfrac)
    windows = [c.plus_seq.bases.encode() for c in covs.values()]
    for i in planted:
        w = windows[rng.randint(len(windows))]
        n = min(len(w), args.readlen)
        raw[i, :n] = np.frombuffer(w[:n], np.uint8)
    codes = encode.encode_read_array(raw)
    codes[np.arange(LPAD)[None, :] >= rl[:, None]] = encode.CODE_READ_JUNK
    dcodes = torch.from_numpy(codes).to(dev).view(nb, args.batch, LPAD)
    drl = torch.from_numpy(rl).to(dev).view(nb, args.batch)

    def step(k, acc):
        *out, count = pallas_scan.scan_step_banked(
            dcodes[k % nb], drl[k % nb], state, MAXERRORS, MINOVERLAP,
            screen, rows)
        if acc is None:
            return out, count
        for a, d in zip(acc, out):
            a += d
        return acc, count

    def sync():
        if dev.type == 'cuda':
            torch.cuda.synchronize(dev)

    t0 = time.time()
    step(0, None)
    sync()
    print('warm-up step: %.2fs' % (time.time() - t0), file=sys.stderr)

    launches = pallas_scan.cand_counts.launches
    scored = pallas_scan.score_candidates.launches
    acc, candmax = None, None
    t0 = time.time()
    for k in range(args.batches):
        # the step count stays on the device: no host round trip per step
        acc, count = step(k, acc)
        candmax = count if candmax is None else torch.maximum(candmax,
                                                              count)
    sync()
    dt = time.time() - t0
    launches = pallas_scan.cand_counts.launches - launches
    scored = pallas_scan.score_candidates.launches - scored

    reads = args.batches * args.batch
    ops = 2.0 * reads * LPAD * state.nch * state.Qp
    hits = int(acc[1][:len(seqs)].sum())
    print('%d reads in %.3fs: %.0f reads/s, %.1f TOP/s (%d hit weight) '
          'on %s' % (reads, dt, reads / dt, ops / dt / 1e12, hits, name))
    print(json.dumps({
        'metric': 'device_bench', 'device': name, 'reads': reads,
        'batch': args.batch, 'seconds': dt, 'reads_per_s': reads / dt,
        'tops': ops / dt / 1e12, 'hit_weight': hits, 'screen': screen,
        'max_candidates': int(candmax), 'cand_launches': launches,
        'score_launches': scored}))


if __name__ == '__main__':
    main()
