'''
The port's counterpart of the repository's ``bench.py``, holding what
``chip_smoke.py`` and the port's tools need of it: the MTBC testsuites
and their template windows, the synthetic FastQ corpus
(:py:func:`generate_fastq`, byte for byte the JAX package's, seed
20260817; its size :py:data:`N_READS` x :py:data:`READLEN` and its place
:py:func:`bench_path`) and the byte-exact numpy oracle gates
(:py:func:`numpy_findseqs`, :py:func:`oracle_basecounts`,
:py:func:`assert_device_matches_oracle`) on the port's own
:py:mod:`~kvarq_tpu_torch.engine.match_numpy`.
'''

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

N_READS = int(os.environ.get('KVARQ_BENCH_READS', '2000000'))
READLEN = int(os.environ.get('KVARQ_BENCH_READLEN', '101'))
MUTRATE = 0.005         # per-base sequencing-error rate in planted reads
PLANT_FRAC = 0.03       # fraction of reads drawn from template loci


def load_mtbc():
    ''' the MTBC testsuites of the repository, loaded by the port '''
    from kvarq_tpu_torch.log import set_warning
    set_warning()
    from kvarq_tpu_torch.testsuites import discover_testsuites, load_testsuites
    paths = discover_testsuites([os.path.join(ROOT, 'testsuites')])
    return load_testsuites(paths, ['MTBC'])


def template_windows(suites, spacing=25):
    from kvarq_tpu_torch.analyse import Analyser
    analyser = Analyser()
    coverages = analyser.load_coverages(suites, spacing=spacing)
    return [c.plus_seq.bases for c in coverages.values()]


def generate_fastq(path, windows, n_reads, readlen, seed=20260817,
                   plant=None):
    ''' deterministic synthetic FastQ (vectorized): mostly random
        background plus a fraction (``plant``, default
        :py:data:`PLANT_FRAC`) of reads drawn from template loci with
        sequencing errors and occasional low-quality tails (exercises
        quality trimming) '''
    plant = PLANT_FRAC if plant is None else plant
    rng = np.random.RandomState(seed)
    bases = np.frombuffer(b'ACGT', dtype=np.uint8)
    qhi, qlo = b'I'[0], b'#'[0]   # Q40 / Q2 (Sanger)

    reads = bases[rng.randint(4, size=(n_reads, readlen))]
    planted = np.flatnonzero(rng.rand(n_reads) < plant) if windows \
        else np.array([], dtype=np.int64)
    for i in planted:
        w = windows[rng.randint(len(windows))].encode()
        if len(w) >= readlen:
            off = rng.randint(len(w) - readlen + 1)
            reads[i] = np.frombuffer(w[off:off + readlen], np.uint8)
        else:
            off = rng.randint(readlen - len(w) + 1)
            reads[i, off:off + len(w)] = np.frombuffer(w, np.uint8)
        errs = np.flatnonzero(rng.rand(readlen) < MUTRATE)
        reads[i, errs] = bases[rng.randint(4, size=len(errs))]

    quals = np.full((n_reads, readlen), qhi, dtype=np.uint8)
    tailed = np.flatnonzero(rng.rand(n_reads) < 0.1)
    tails = rng.randint(1, readlen // 2, size=len(tailed))
    col = np.arange(readlen)
    quals[tailed] = np.where(col >= readlen - tails[:, None], qlo,
                             quals[tailed])

    with open(path, 'wb') as f:
        for lo_ in range(0, n_reads, 65536):
            hi = min(n_reads, lo_ + 65536)
            parts = []
            for i in range(lo_, hi):
                parts.append(b'@r%d\n' % i)
                parts.append(reads[i].tobytes())
                parts.append(b'\n+\n')
                parts.append(quals[i].tobytes())
                parts.append(b'\n')
            f.write(b''.join(parts))


def bench_path(tag):
    ''' where the corpus of ``tag`` lives: the root ``bench.py``'s name,
        under ``build/kvarq_tpu_torch/bench/`` of the checkout (the root's
        is under ``/tmp``) '''
    plant = '' if PLANT_FRAC == 0.03 else '_p%g' % PLANT_FRAC
    return os.path.join(ROOT, 'build', 'kvarq_tpu_torch', 'bench',
                        'kvarq_bench_%s_%dx%d%s.fastq'
                        % (tag, N_READS, READLEN, plant))


def numpy_findseqs(path, seqs):
    ''' the port engine's ``findseqs`` under its current configuration,
        with the byte-exact numpy matcher (backend ``numpy``) on every
        batch and no sieve: the oracle hit stream '''
    from kvarq_tpu_torch import engine
    saved = {k: engine._extra_config[k] for k in ('backend', 'sieve')}
    engine.config(backend='numpy', sieve='off')
    try:
        return engine.findseqs(path, seqs)
    finally:
        engine.config(**saved)


def oracle_basecounts(found, seqs):
    ''' rebuild per-strand [5, S] base counts from a findseqs hit list
        (the numpy oracle's output) -- the exact quantity countseqs
        accumulates on device: the engine's numpy-path fold '''
    from kvarq_tpu_torch import engine
    return engine._basecounts_from_hits(found['hits'], found['hitseqs'], seqs)


def assert_device_matches_oracle(device_ret, path, seqs, found=None):
    ''' compare a countseqs() result against the byte-exact numpy golden
        matcher on the same input (:py:func:`numpy_findseqs`, under the
        port engine's configuration); raise SystemExit on ANY divergence.
        :returns: the oracle findseqs result (pure in (path, seqs)), so
        repeated gates over the same input can reuse it via ``found`` '''
    if found is None:
        found = numpy_findseqs(path, seqs)

    dev, ora = device_ret['stats'], found['stats']
    for key in ('nseqhits', 'nseqbasehits', 'records_parsed'):
        if dev[key] != ora[key]:
            raise SystemExit('BIT-EXACTNESS FAILURE: stats[%r] device=%r '
                             'oracle=%r' % (key, dev[key], ora[key]))
    want = oracle_basecounts(found, seqs)
    for t, (got, exp) in enumerate(zip(device_ret['basecounts'], want)):
        if not np.array_equal(np.asarray(got, np.int64), exp):
            raise SystemExit('BIT-EXACTNESS FAILURE: basecounts[%d] '
                             '(template %r...) differ' % (t, seqs[t][:20]))
    total = int(np.asarray(dev['nseqhits']).sum())
    print('bit-exactness vs numpy oracle: OK (%d hits, %d templates)'
          % (total, len(seqs)), file=sys.stderr)
    return found
