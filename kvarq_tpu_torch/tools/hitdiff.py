#!/usr/bin/env python
'''
Hit-level differential harness of the port (counterpart of
tools/hitdiff.py): diffs the FULL hit-tuple stream ``(seq_nr, file_pos,
seq_pos, length, readlength)`` of the port's ``engine.findseqs`` against
``kvarq_tpu_torch/csrc/ref_bench.c``, the C re-implementation of the
reference hot loop (``tools/ref_bench.c``'s code, byte for byte) --
every tuple in order, not just total counts, so a compensating-error
pair cannot hide.

Covers the checked-in engine fixture (templates of 3-4 bases, where the
k-mer sieve cannot apply), the golden 5k MTBC extract against the MTBC
bank (not with ``--quick``) and randomized corpora built to exercise all
4 overlap modes (reads of 12-159 bases against templates of 15-199,
planted mutations 0-3, low-quality heads, tails and islands, ``N`` bases
in every second corpus), swept over maxerrors 0-3 and minoverlap 3, 10,
20 and 25.  One more corpus than kvarq_tpu's tool has: templates with
``N`` bases (a bank of 5 one-hot channels) against reads with ``N``.

The engine runs on ``--device`` (``cuda``, the default: the candidate
screen kernel on every batch; ``cpu``: exact extraction alone), or with
``--backend numpy`` on the host's byte-exact numpy matcher.  The C
reference is built with ``cc`` (or ``gcc``, ``clang``) into
``build/kvarq_tpu_torch/``; with no C compiler the tool fails.

Usage:
    python -m kvarq_tpu_torch.tools.hitdiff [--quick] [--device cuda|cpu]
        [--backend numpy]

Exit 0 = every stream identical; a differing stream aborts with the
first differing hit and its neighbours.  The last line of the output is
one JSON object (hits compared, cases, device, backend, kernel
launches).  ``run_case()`` and ``build_ref_bench()`` are importable.
'''

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCE = os.path.join(ROOT, 'kvarq_tpu_torch', 'csrc', 'ref_bench.c')
BUILD = os.path.join(ROOT, 'build', 'kvarq_tpu_torch')
FIXTURE = os.path.join(ROOT, 'tests', 'fastqs', 'test_engine.fastq')
GOLDEN = os.path.join(ROOT, 'tests', 'fastqs', 'L3_N1014_hits_5k.fastq')


def build_ref_bench(outdir=BUILD):
    ''' compile ref_bench.c into ``outdir``; returns the binary path or
        None if no C compiler is available '''
    os.makedirs(outdir, exist_ok=True)
    binpath = os.path.join(outdir, 'ref_bench')
    tmp = '%s.%d.tmp' % (binpath, os.getpid())
    for cc in ('cc', 'gcc', 'clang'):
        try:
            subprocess.run([cc, '-O2', '-o', tmp, SOURCE, '-lpthread'],
                           check=True, capture_output=True)
        except (OSError, subprocess.CalledProcessError):
            continue
        os.replace(tmp, binpath)
        return binpath
    return None


def ref_hits(binpath, fastq, seqs, amin, maxerrors, minoverlap,
             minreadlength, workdir):
    ''' run ref_bench with the hit dump; returns the list of tuple lines '''
    tpl = os.path.join(workdir, 'templates.txt')
    with open(tpl, 'w') as f:
        f.write('\n'.join(seqs) + '\n')
    dump = os.path.join(workdir, 'hits.txt')
    subprocess.run(
        [binpath, fastq, tpl, str(amin), str(maxerrors), str(minoverlap),
         str(minreadlength), '1', dump],
        check=True, capture_output=True)
    with open(dump) as f:
        return f.read().splitlines()


def engine_hits(fastq, seqs, amin, maxerrors, minoverlap, minreadlength,
                device='cuda', backend='device'):
    ''' run the port's engine.findseqs; returns hit-tuple lines in the
        same format '''
    from kvarq_tpu_torch import engine
    engine.config(maxerrors=maxerrors, minoverlap=minoverlap,
                  minreadlength=minreadlength, nthreads=2,
                  Amin=chr(amin), device=device, backend=backend)
    found = engine.findseqs(fastq, seqs)
    return ['%d %d %d %d %d' % h for h in found['hits']]


def run_case(binpath, fastq, seqs, amin, maxerrors, minoverlap,
             minreadlength, workdir, device='cuda', backend='device'):
    ''' diff the two hit streams; raises AssertionError with context '''
    ref = ref_hits(binpath, fastq, seqs, amin, maxerrors, minoverlap,
                   minreadlength, workdir)
    got = engine_hits(fastq, seqs, amin, maxerrors, minoverlap,
                      minreadlength, device, backend)
    if ref != got:
        n = min(len(ref), len(got))
        first = next((i for i in range(n) if ref[i] != got[i]), n)
        ctx = '\n'.join(
            '  ref=%-30s got=%s' % (ref[i] if i < len(ref) else '<end>',
                                    got[i] if i < len(got) else '<end>')
            for i in range(max(0, first - 2), min(first + 3,
                                                  max(len(ref), len(got)))))
        raise AssertionError(
            'hit streams differ (%s e=%d o=%d r=%d): %d vs %d hits, '
            'first divergence at %d:\n%s'
            % (os.path.basename(fastq), maxerrors, minoverlap,
               minreadlength, len(ref), len(got), first, ctx))
    return len(ref)


def random_corpus(path, seqs, n_reads, seed, with_n=False):
    ''' randomized FastQ engineered to hit all 4 overlap modes: reads of
        varying length (some shorter than the shortest template, some
        longer than the longest), template substrings planted at the
        read head/tail/middle with 0-3 mutations, plus background junk
        and low-quality segments '''
    rng = np.random.RandomState(seed)
    alphabet = b'ACGTN' if with_n else b'ACGT'
    bases = np.frombuffer(alphabet, dtype=np.uint8)
    lines = []
    for i in range(n_reads):
        rl = int(rng.randint(12, 160))
        read = bases[rng.randint(len(bases), size=rl)]
        if rng.rand() < 0.7:
            w = seqs[rng.randint(len(seqs))].encode()
            nmut = int(rng.randint(0, 4))
            frag = np.frombuffer(w, np.uint8).copy()
            if nmut:
                pos = rng.choice(len(frag), size=min(nmut, len(frag)),
                                 replace=False)
                frag[pos] = bases[rng.randint(len(bases), size=len(pos))]
            mode = rng.randint(4)
            if mode == 0 and rl > 1:           # template tail at read head
                k = min(rl, len(frag), 1 + rng.randint(len(frag)))
                read[:k] = frag[len(frag) - k:]
            elif mode == 1 and rl > 1:         # template head at read tail
                k = min(rl, len(frag), 1 + rng.randint(len(frag)))
                read[rl - k:] = frag[:k]
            elif mode == 2 and rl > len(frag):  # template inside read
                off = rng.randint(rl - len(frag) + 1)
                read[off:off + len(frag)] = frag
            else:                               # read inside template
                if len(frag) >= rl:
                    off = rng.randint(len(frag) - rl + 1)
                    read[:] = frag[off:off + rl]
                else:
                    read[:len(frag)] = frag
        qual = np.full(rl, b'I'[0], dtype=np.uint8)
        r = rng.rand()
        if r < 0.15:      # low-quality tail
            qual[rl - rng.randint(1, max(2, rl // 2)):] = b'#'[0]
        elif r < 0.25:    # low-quality head (shifts the trim window)
            qual[:rng.randint(1, max(2, rl // 2))] = b'#'[0]
        elif r < 0.30:    # interior low-quality island (two runs, tie
            p = rng.randint(rl)            # cases for first-longest-run)
            qual[p:p + 1] = b'#'[0]
        lines.append(b'@r%d\n%s\n+\n%s\n'
                     % (i, read.tobytes(), qual.tobytes()))
    with open(path, 'wb') as f:
        f.write(b''.join(lines))


def random_templates(rng, n, lmin=15, lmax=200):
    bases = np.frombuffer(b'ACGT', dtype=np.uint8)
    return [bytes(bases[rng.randint(4, size=rng.randint(lmin, lmax))])
            .decode() for _ in range(n)]


def _revcomp(s):
    comp = dict(zip('ACGT', 'TGCA'))
    return ''.join(comp.get(c, c) for c in reversed(s))


def cases(workdir, quick=False):
    ''' the sweep's cases, ``(fastq, seqs, amin, maxerrors, minoverlap,
        minreadlength)``; corpora are written into ``workdir`` '''
    # 1. the handwritten engine fixture with its quirky templates
    plus = ['CACCGGTGTAGGCAAGTCGTAACAAGG', 'TTTTTTTTTTGGGGGGGGGG', 'CCCC',
            'CCC']
    seqs = plus + [_revcomp(s) for s in plus]
    for e in range(4):
        for mo in (3, 10, 20):
            yield FIXTURE, seqs, 33 + 2, e, mo, 3

    # 2. the golden 5k MTBC extract against the real template bank
    if not quick:
        from kvarq_tpu_torch import bench
        from kvarq_tpu_torch.analyse import Analyser
        covs = Analyser().load_coverages(bench.load_mtbc(), spacing=25)
        mtbc = [c.plus_seq.bases for c in covs.values()] \
            + [c.minus_seq.bases for c in covs.values()]
        for e in (0, 2, 3):
            yield GOLDEN, mtbc, 33 + 13, e, 25, 25

    # 3. randomized corpora x maxerrors x minoverlap sweep
    rng = np.random.RandomState(20260820)
    for c in range(2 if quick else 6):
        seqs = random_templates(rng, 12)
        corpus = os.path.join(workdir, 'corpus%d.fastq' % c)
        random_corpus(corpus, seqs, 200 if quick else 1000, seed=1000 + c,
                      with_n=(c % 2 == 1))
        for e in range(4):
            for mo in (10, 25):
                yield corpus, seqs, 33 + 10, e, mo, 10

    # 4. templates with N bases, whose bank needs the fifth (N) one-hot
    # channel, against reads with N (a case kvarq_tpu's tool does not have)
    rng = np.random.RandomState(20260821)
    seqs = []
    for s in random_templates(rng, 12):
        b = np.frombuffer(s.encode(), np.uint8).copy()
        b[rng.rand(len(b)) < 0.05] = ord('N')
        seqs.append(b.tobytes().decode())
    corpus = os.path.join(workdir, 'corpus_n.fastq')
    random_corpus(corpus, seqs, 200 if quick else 1000, seed=2000,
                  with_n=True)
    for e in range(4):
        for mo in (3, 10, 25):
            yield corpus, seqs, 33 + 10, e, mo, 10


def sweep(binpath, workdir, quick=False, device='cuda', backend='device'):
    ''' :py:func:`run_case` over :py:func:`cases`;
        :returns: ``(hits compared, cases)`` '''
    total = n = 0
    for case in cases(workdir, quick):
        total += run_case(binpath, *case, workdir, device, backend)
        n += 1
    return total, n


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--quick', action='store_true',
                    help='no golden MTBC cases, 2 corpora of 200 reads')
    ap.add_argument('--device', default='cuda', choices=('cuda', 'cpu'))
    ap.add_argument('--backend', default='device',
                    choices=('device', 'numpy'),
                    help='numpy: the host\'s numpy matcher, no device')
    args = ap.parse_args(argv)

    from kvarq_tpu_torch.engine import pallas_scan
    from kvarq_tpu_torch.log import set_warning
    set_warning()
    if args.backend == 'device':
        from kvarq_tpu_torch import device
        device.select(args.device)

    with tempfile.TemporaryDirectory(dir=_workroot()) as tmp:
        binpath = build_ref_bench()
        if binpath is None:
            print('no C compiler available', file=sys.stderr)
            return 1
        launches = pallas_scan.cand_counts.launches
        total, n = sweep(binpath, tmp, args.quick, args.device, args.backend)
        launches = pallas_scan.cand_counts.launches - launches

    print('hit streams identical over all cases (%d hits compared in %d '
          'cases, device=%s, backend=%s)'
          % (total, n, args.device, args.backend))
    print(json.dumps({'hits': total, 'cases': n, 'device': args.device,
                      'backend': args.backend, 'cand_launches': launches}))
    return 0


def _workroot():
    ''' the corpora's directory, inside the checkout's build tree '''
    path = os.path.join(BUILD, 'hitdiff')
    os.makedirs(path, exist_ok=True)
    return path


if __name__ == '__main__':
    sys.exit(main())
