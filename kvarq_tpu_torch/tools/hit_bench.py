#!/usr/bin/env python
'''
The hit-list scan (``findseqs``, ``kvarq scan -H/-x``) on the card over the
bench corpus: per cell the wall time, the seconds in the matcher (screen,
compaction, extraction, the triplets' readback) and in the host's
``_emit``, the cell's own peak device memory, the kernels' launches, and
one scan under torch.profiler for the kernel time on the card.

Methodology: ``kvarq_tpu_torch.bench``'s corpus (2M reads x 101 bp, 3%
planted from the MTBC template loci, seed 20260817) and a hit-dense one
(262,144 reads, half planted); the MTBC testsuites, both strands; the CLI
defaults (e=2, o=25, r=25, Q13, 8 reader threads).  Cells: hits with the
sieve off, with it on, and hit-dense with it off.  One warm-up scan of
the first 8192 reads per sieve mode, then ``--repeat`` scans per cell,
each reported.  Every scan's hit stream must equal the cell's first.

The file imports only what older checkouts of the port also have, so it
can time one as a script with that checkout first on ``PYTHONPATH``
(``PYTHONPATH=old python kvarq_tpu_torch/tools/hit_bench.py``): compare
two trees within one call, in turns.

Usage:
    python -m kvarq_tpu_torch.tools.hit_bench [--repeat 2] [--no-trace]

The last line of the output is one JSON object with the numbers, the
card's name and power limit, and the checkout the package came from.
'''

import argparse
import json
import os
import subprocess
import sys
import time

import torch

SCAN = dict(maxerrors=2, minoverlap=25, minreadlength=25, nthreads=8,
            Amin=chr(33 + 13))
# (cell, reads, planted fraction (None: the bench's), sieve)
CELLS = [('hits sieve=off', 2000000, None, 'off'),
         ('hits sieve=on', 2000000, None, 'auto'),
         ('hits hit-dense sieve=off', 262144, 0.5, 'off')]
READLEN = 101
KERNELS = ('cand_screen_kernel', 'hit_extract_kernel', 'score_step_kernel')


def corpus(bench, windows, n_reads, plant):
    ''' the corpus file (made once, under the package's build directory)
        and a file of its first 8192 reads '''
    where = os.path.dirname(bench.bench_path('hits'))
    os.makedirs(where, exist_ok=True)
    tag = 'hits_%dx%d%s' % (n_reads, READLEN,
                            '_p%g' % plant if plant is not None else '')
    path = os.path.join(where, tag + '.fastq')
    prefix = os.path.join(where, tag + '_prefix.fastq')
    if not os.path.exists(path):
        bench.generate_fastq(path + '.tmp', windows, n_reads, READLEN,
                             plant=plant)
        os.replace(path + '.tmp', path)
    if not os.path.exists(prefix):
        with open(path) as f, open(prefix + '.tmp', 'w') as g:
            for _ in range(4 * 8192):
                g.write(f.readline())
        os.replace(prefix + '.tmp', prefix)
    return path, prefix


def launches(tps):
    return {name: getattr(tps, name).launches
            for name in ('cand_counts', 'score_candidates', 'hit_triplets')
            if hasattr(tps, name)}


def timed_findseqs(engine, tps, path, seqs):
    ''' one findseqs: ``(result, numbers)`` -- wall, matcher and ``_emit``
        seconds, peak device memory and launches of this scan '''
    emit, make = engine._emit, engine._make_matcher
    spent = {'matcher': 0.0, '_emit': 0.0}

    def timing(key, fn):
        def call(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                spent[key] += time.perf_counter() - t0
        return call

    def make_timed(seqs_):
        m = make(seqs_)
        m.match_batch = timing('matcher', m.match_batch)
        return m

    engine._emit = timing('_emit', emit)
    engine._make_matcher = make_timed
    for name in launches(tps):
        getattr(tps, name).launches = 0
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        found = engine.findseqs(path, seqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        engine._emit, engine._make_matcher = emit, make
    return found, dict(wall=wall, matcher=spent['matcher'],
                       emit=spent['_emit'],
                       peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                       hits=len(found['hits']), launches=launches(tps))


def traced_findseqs(engine, path, seqs):
    ''' one findseqs under torch.profiler: wall, kernel seconds on the
        card and per kernel of the port '''
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.findseqs(path, seqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    out = dict(wall=wall,
               busy=sum(e.self_device_time_total for e in dev) / 1e6)
    for name in KERNELS:
        out[name] = sum(e.self_device_time_total for e in dev
                        if name in e.key) / 1e6
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--repeat', type=int, default=2,
                    help='timed scans per cell')
    ap.add_argument('--no-trace', action='store_true',
                    help='skip the traced scan')
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print('hit_bench: no CUDA device', file=sys.stderr)
        return 1
    import kvarq_tpu_torch
    from kvarq_tpu_torch import bench, engine
    from kvarq_tpu_torch.analyse import Analyser
    from kvarq_tpu_torch.engine import pallas_scan as tps
    from kvarq_tpu_torch.log import set_warning
    set_warning()

    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else torch.cuda.get_device_name(0)
    tree = os.path.dirname(os.path.dirname(
        os.path.abspath(kvarq_tpu_torch.__file__)))
    suites = bench.load_mtbc()
    windows = bench.template_windows(suites)
    covs = Analyser().load_coverages(suites, spacing=25)
    seqs = [c.plus_seq.bases for c in covs.values()]
    seqs += [c.minus_seq.bases for c in covs.values()]

    result = {}
    for cell, n_reads, plant, sieve in CELLS:
        path, prefix = corpus(bench, windows, n_reads, plant)
        engine.config(device='cuda', sieve=sieve, **SCAN)
        engine.findseqs(prefix, seqs)          # kernel builds, bank state
        runs, first = [], None
        for _ in range(args.repeat):
            found, r = timed_findseqs(engine, tps, path, seqs)
            if first is None:
                first = found
            elif found != first:
                print('hit_bench: %s: two scans gave different hit streams'
                      % cell, file=sys.stderr)
                return 1
            print('%s: %d reads, %d hits; wall %.3fs, matcher %.3fs, _emit '
                  '%.3fs; peak device memory %.3f GB; launches %s; %s' % (
                      cell, n_reads, r['hits'], r['wall'], r['matcher'],
                      r['emit'], r['peak_gb'], r['launches'], card),
                  flush=True)
            runs.append(r)
        result[cell] = dict(runs=runs)
        if not args.no_trace and sieve == 'off' and plant is None:
            t = traced_findseqs(engine, path, seqs)
            print('%s traced: wall %.3fs, kernel time on the card %.3fs; %s'
                  % (cell, t['wall'], t['busy'], ', '.join(
                      '%s %.4fs' % (k, t[k]) for k in KERNELS)), flush=True)
            result[cell]['trace'] = t
    print(json.dumps({'metric': 'hit_bench', 'device': card, 'tree': tree,
                      'cells': result}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
