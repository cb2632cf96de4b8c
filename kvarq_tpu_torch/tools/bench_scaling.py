#!/usr/bin/env python
'''
Multi-card scaling harness of the port (counterpart of
tools/bench_scaling.py): scans one synthetic workload with the sharded
scanner (:py:class:`kvarq_tpu_torch.parallel.ShardedScanner`) on meshes
of 1, 2, 4, ... entries on the data axis, up to ``--max`` (default:
every card), and reports reads/s per entry count and the scaling
efficiency.  When ``--max`` exceeds the cards, the cards repeat
cyclically, as ``parallel.dryrun`` does: such entries share a card and
measure the mesh's own overhead, not scaling.  With ``--device cpu``
every entry is the CPU (kvarq_tpu's ``--virtual`` has no counterpart).

Usage:
    python -m kvarq_tpu_torch.tools.bench_scaling [--max 4]
        [--reads 100000] [--device cpu]

The last line of the output is the JSON of the JAX tool.
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
SUB = 16384


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--max', type=int, default=None,
                    help='largest mesh (default: every card; 1 on the CPU)')
    ap.add_argument('--reads', type=int, default=100000)
    ap.add_argument('--readlen', type=int, default=101)
    ap.add_argument('--device', default='cuda', choices=('cuda', 'cpu'))
    args = ap.parse_args(argv)

    from kvarq_tpu_torch import bench, device, parallel
    from kvarq_tpu_torch.analyse import Analyser
    from kvarq_tpu_torch.engine import encode
    from kvarq_tpu_torch.engine.reader import RecordBatch

    dev = device.select(args.device)
    if dev.type == 'cuda':
        ncards = torch.cuda.device_count()
        name = '%d x %s' % (ncards, torch.cuda.get_device_name(0))
        entries = ['cuda:%d' % k for k in range(ncards)]
    else:
        name = 'cpu'
        entries = ['cpu']
    largest = args.max or len(entries)
    print('devices: %s' % name, file=sys.stderr)

    covs = Analyser().load_coverages(bench.load_mtbc(), spacing=SPACING)
    seqs = [c.plus_seq.bases for c in covs.values()]
    seqs += [c.minus_seq.bases for c in covs.values()]

    rng = np.random.RandomState(0)
    B = args.reads
    raw = rng.choice(np.frombuffer(b'ACGT', np.uint8), (B, LPAD))
    for b in range(0, B, 32):
        s = seqs[rng.randint(len(seqs))].encode()[:args.readlen]
        raw[b, :len(s)] = np.frombuffer(s, np.uint8)
    codes = encode.encode_read_array(raw)
    rl = np.full(B, args.readlen, np.int32)
    codes[np.arange(LPAD)[None, :] >= rl[:, None]] = encode.CODE_READ_JUNK

    def sync():
        if dev.type == 'cuda':
            torch.cuda.synchronize()

    results = {}
    n = 1
    while n <= largest:
        devices = [entries[k % len(entries)] for k in range(n)]
        mesh = parallel.make_mesh(n_data=n, n_bank=1, devices=devices)
        sc = parallel.ShardedScanner(seqs, MAXERRORS, MINOVERLAP, mesh=mesh)
        # warm up
        sc.scan_batch(RecordBatch(codes[:SUB], rl[:SUB], None, None))
        sc.finalize()
        sync()
        sc.reset()
        sc.launches[:] = 0
        t0 = time.time()
        for lo_ in range(0, B, SUB):
            sc.scan_batch(RecordBatch(codes[lo_:lo_ + SUB], rl[lo_:lo_ + SUB],
                                      None, None))
        sc.finalize()
        sync()
        dt = time.time() - t0
        total_hits = int(sc.seqhits.sum())
        rps = B / dt
        results[n] = rps
        eff = rps / (results[1] * n)
        print('%2d entries on %s: %8.0f reads/s  (%.2f efficiency, %d hits, '
              'K1 launches per entry %s)' % (
                  n, ' '.join(devices), rps, eff, total_hits,
                  sc.launches.ravel().tolist()), file=sys.stderr)
        n *= 2

    base = results.get(1, 1)
    print(json.dumps({
        'metric': 'scaling_efficiency',
        'per_device_reads_per_s': results,
        'efficiency': {n: round(r / (base * n), 3)
                       for n, r in results.items()},
    }))


if __name__ == '__main__':
    main()
