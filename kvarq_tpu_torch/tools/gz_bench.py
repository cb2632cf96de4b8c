#!/usr/bin/env python
'''
Host-reader throughput of the port on large compressed inputs
(counterpart of tools/gz_bench.py): plain FastQ against BGZF (parallel
per-block decode) against single-member gzip (streaming inflate), all
through the port's reader (:py:mod:`kvarq_tpu_torch.engine.reader`, its
copy of the C++ reader and ``csrc/kvq_fast_inflate.h``).

Builds a big corpus once (the bench corpus of
:py:mod:`kvarq_tpu_torch.bench`, ``N_READS`` x ``READLEN``, repeated),
then drains the reader's batches over each variant.  Files go to
``build/kvarq_tpu_torch/gz_bench/`` of the checkout.

Usage:
    python -m kvarq_tpu_torch.tools.gz_bench [--repeat 8] [--nthreads 2]
        [--sieve] [--sweep N1,N2,... [--sweep-gz]]
'''

import argparse
import os
import struct
import sys
import time
import zlib

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
WORK = os.path.join(ROOT, 'build', 'kvarq_tpu_torch', 'gz_bench')


def write_bgzf(dst, src, block=60000, level=1):
    ''' re-compress ``src`` into BGZF blocks (level 1: bgzip-style fast;
        decode speed is what is measured) '''
    with open(src, 'rb') as fin, open(dst, 'wb') as fout:
        while True:
            chunk = fin.read(block)
            co = zlib.compressobj(level, zlib.DEFLATED, -15)
            cdata = co.compress(chunk) + co.flush()
            bsize = 12 + 6 + len(cdata) + 8
            fout.write(struct.pack('<BBBBIBBH', 0x1f, 0x8b, 8, 4, 0, 0,
                                   0xff, 6))
            fout.write(struct.pack('<BBHH', ord('B'), ord('C'), 2,
                                   bsize - 1))
            fout.write(cdata)
            fout.write(struct.pack('<II', zlib.crc32(chunk) & 0xffffffff,
                                   len(chunk)))
            if not chunk:
                break


def write_gz(dst, src, level=1):
    ''' re-compress ``src`` into one gzip member '''
    co = zlib.compressobj(level, zlib.DEFLATED, 16 + 15)
    with open(src, 'rb') as fin, open(dst, 'wb') as fout:
        while True:
            chunk = fin.read(1 << 22)
            if not chunk:
                break
            fout.write(co.compress(chunk))
        fout.write(co.flush())


def drain(fname, nthreads, sieve=None):
    ''' the reader's batches over ``fname`` (Q ``.``, minimum read length
        25, 65,536-read batches, codes alone as the coverage scan reads
        them): ``(records parsed, reads passed, bytes parsed, wall s)`` '''
    from kvarq_tpu_torch.engine import reader
    stats = reader.ReaderStats()
    t0 = time.time()
    nreads = 0
    for batch in reader.batches([fname], ord('.'), 25, stats,
                                batchsize=65536, sieve=sieve,
                                nthreads=nthreads, raw=False):
        nreads += len(batch)
    dt = time.time() - t0
    return stats.records_parsed, nreads, stats.parsed, dt


def mtbc_sieve():
    ''' the k-mer sieve of the MTBC bank at the CLI defaults (e=2, o=25,
        r=25) '''
    from kvarq_tpu_torch import bench
    from kvarq_tpu_torch.analyse import Analyser
    from kvarq_tpu_torch.engine.sieve import KmerSieve
    covs = Analyser().load_coverages(bench.load_mtbc(), spacing=25)
    seqs = [c.plus_seq.bases for c in covs.values()]
    seqs += [c.minus_seq.bases for c in covs.values()]
    return KmerSieve.build(seqs, 2, 25, 25)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--repeat', type=int, default=8,
                    help='copies of the bench corpus (~430 MB raw each at '
                         '2M reads)')
    ap.add_argument('--nthreads', type=int, default=2)
    ap.add_argument('--sieve', action='store_true',
                    help='also run the MTBC k-mer sieve (production path)')
    ap.add_argument('--sweep', default=None, metavar='N1,N2,...',
                    help='thread-scaling mode: run the plain (and, with '
                         '--sweep-gz, the gz) variant at each worker '
                         'count and print a scaling table (sets '
                         'KVARQ_THREADS_EXACT so the cores+2 clamp does '
                         'not rewrite the requested counts)')
    ap.add_argument('--sweep-gz', action='store_true',
                    help='include the single-member gz variant in --sweep')
    args = ap.parse_args(argv)

    from kvarq_tpu_torch import bench
    base = bench.bench_path('mtbc')
    if not os.path.exists(base):
        os.makedirs(os.path.dirname(base), exist_ok=True)
        windows = bench.template_windows(bench.load_mtbc())
        bench.generate_fastq(base + '.tmp', windows, bench.N_READS,
                             bench.READLEN)
        os.replace(base + '.tmp', base)

    os.makedirs(WORK, exist_ok=True)
    big = os.path.join(WORK, 'kvarq_gzbench_%d.fastq' % args.repeat)
    if not os.path.exists(big):
        t0 = time.time()
        with open(big + '.tmp', 'wb') as out, open(base, 'rb') as fin:
            data = fin.read()
            for _ in range(args.repeat):
                out.write(data)
        os.replace(big + '.tmp', big)
        print('built %s (%.2f GB) in %.0fs'
              % (big, os.path.getsize(big) / 1e9, time.time() - t0),
              file=sys.stderr)
    for variant, builder in (('.bgzf.gz', write_bgzf), ('.gz', write_gz)):
        dst = big + variant
        if not os.path.exists(dst):
            t0 = time.time()
            builder(dst + '.tmp', big)
            os.replace(dst + '.tmp', dst)
            print('built %s (%.2f GB) in %.0fs'
                  % (dst, os.path.getsize(dst) / 1e9, time.time() - t0),
                  file=sys.stderr)

    sieve = mtbc_sieve() if args.sieve else None

    if args.sweep:
        counts = [int(x) for x in args.sweep.split(',')]
        os.environ['KVARQ_THREADS_EXACT'] = '1'
        variants = [('plain', big)] + \
            ([('gz', big + '.gz')] if args.sweep_gz else [])
        base_rate = {}
        print('%-6s %8s %12s %9s %8s'
              % ('input', 'threads', 'reads/s', 'MB/s', 'scaling'))
        for label, fname in variants:
            for nt in counts:
                nrec, _, parsed, dt = drain(fname, nt, sieve)
                rate = nrec / dt
                base_rate.setdefault(label, rate)
                print('%-6s %8d %12.0f %9.0f %7.2fx'
                      % (label, nt, rate, parsed / dt / 1e6,
                         rate / base_rate[label]))
        return 0

    results = {}
    for label, fname in (('plain', big), ('bgzf', big + '.bgzf.gz'),
                         ('gz', big + '.gz')):
        nrec, nreads, parsed, dt = drain(fname, args.nthreads, sieve)
        results[label] = nrec / dt
        print('%-6s %9d records, %5.2f GB decompressed in %6.1fs: '
              '%8.0f reads/s, %6.0f MB/s'
              % (label, nrec, parsed / 1e9, dt, nrec / dt,
                 parsed / dt / 1e6))
    for label in ('bgzf', 'gz'):
        print('%s vs plain: %.0f%%'
              % (label, 100 * results[label] / results['plain']))
    return 0


if __name__ == '__main__':
    sys.exit(main())
