'''
Samples of a configuration, made from the seed: a strain cut from the
ancestral genome by seeded substitutions, and Illumina reads drawn from
it, written as FastQ (plain, or gzip of several members).

The model, all of it named in the configuration's ``reads`` and ``model``:

- the strain: substitutions at ``snp_rate`` over the genome, one
  lineage's marker SNPs or none, up to ``resistance_snps`` resistance
  SNPs, and ``window_snps`` substitutions inside the template windows'
  regions of interest;
- single reads: a start uniform over the strain, either strand;
  pairs: a fragment of normal length (``fragment``), clipped, read from
  both ends inward, either strand;
- a panel (``reads.panel``, optional): amplicons ``[start, stop]``,
  1-based and inclusive in the genome's coordinates (the strain has
  substitutions only). A read or pair comes from one amplicon, picked
  with chance proportional to its length (an equimolar pool,
  fragmented), and lies wholly inside it: a pair's fragment is clipped
  to the amplicon's length too. A share ``reads.off_target`` (default 0)
  of reads or pairs is drawn over the whole strain as without a panel;
- sequencing errors: each base at ``error_rate`` replaced by another;
- qualities: copied from real reads of an instrument (``qualities``, one
  quality line a line, frozen from the repository's FastQ fixtures): a
  read follows one real line and, at each cycle with chance
  ``quality_switch``, goes on along another that had the same quality at
  the cycle before. Each cycle's qualities and each step from one to the
  next are the real reads', and no whole line comes back for gzip to
  find. A read cycle takes the source's same cycle where the source
  reads that far, and the one at the same share of the read where it does
  not (a 51-cycle profile stretched over 101).

Reads are made and written in blocks, each from its own stream of the
seed, so blocks can run on several threads and a sample is the same for
one seed whatever the threads.
'''

import gzip
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BASES = np.frombuffer(b'ACGT', np.uint8)
_CODE = np.full(256, 255, np.uint8)
for _i, _c in enumerate(b'ACGT'):
    _CODE[_c] = _i
BLOCK = 1 << 17            # reads (or pairs) a block


def strain(genome_codes, group, model, rng):
    ''' (strain base codes, [(1-based position, base), ...] planted) '''
    g = genome_codes.copy()
    size = len(g)
    n = rng.binomial(size, model['snp_rate'])
    pos = rng.integers(0, size, n)
    g[pos] = (g[pos] + rng.integers(1, 4, n)) % 4
    lineages, resistance = group.marker_sites()
    pick = int(rng.integers(0, len(lineages) + 1))
    planted = list(lineages[pick]) if pick < len(lineages) else []
    lo, hi = model['resistance_snps']
    nres = int(rng.integers(lo, hi + 1))
    planted += [resistance[i] for i in
                rng.choice(len(resistance), nres, replace=False)]
    spans = group.region_spans()
    for _ in range(model['window_snps']):
        a, b = spans[int(rng.integers(0, len(spans)))]
        p = int(rng.integers(a, b + 1))
        planted.append((p, 'ACGT'[(g[p - 1] + int(rng.integers(1, 4))) % 4]))
    for p, base in planted:
        g[p - 1] = _CODE[ord(base)]
    return g, planted


def _reads(g, starts, minus, length):
    ''' [n, length] codes of the reads starting at ``starts``, reverse
        complemented where ``minus`` '''
    seq = g[starts[:, None] + np.arange(length)]
    seq[minus] = 3 - seq[minus, ::-1]
    return seq


def _errors(seq, rate, rng):
    n = rng.binomial(seq.size, rate)
    flat = rng.integers(0, seq.size, n)
    seq.flat[flat] = (seq.flat[flat] + rng.integers(1, 4, n)) % 4


class QualityLines:
    ''' quality lines of ``length`` cycles copied from the real lines in
        ``path`` (one a line): a read starts on a real line drawn at
        random, and at each next cycle, with chance ``switch``, goes on
        along another real line that had the same quality at the cycle
        before, drawn among those '''

    def __init__(self, path, length, switch):
        with open(path, 'rb') as fd:
            lines = [x for x in fd.read().split(b'\n') if x]
        source = min(len(x) for x in lines)
        self.lines = np.array([np.frombuffer(x[:source], np.uint8)
                               for x in lines])
        # for each source cycle, the lines in the order of their quality
        self.order = np.argsort(self.lines, axis=0, kind='stable')
        self.sorted = np.take_along_axis(self.lines, self.order, 0)
        cycles = np.arange(length)
        if length > source:
            cycles = cycles * source // length
        self.cycles = cycles
        self.switch = switch

    def draw(self, n, rng):
        ''' [n, length] quality bytes '''
        lines, cycles = self.lines, self.cycles
        line = rng.integers(0, len(lines), n)
        out = np.empty((n, len(cycles)), np.uint8)
        out[:, 0] = lines[line, cycles[0]]
        for i in range(1, len(cycles)):
            c = cycles[i - 1]
            moved = np.flatnonzero(rng.random(n) < self.switch)
            q = lines[line[moved], c]
            lo = np.searchsorted(self.sorted[:, c], q, 'left')
            hi = np.searchsorted(self.sorted[:, c], q, 'right')
            pick = lo + (rng.random(len(moved)) * (hi - lo)).astype(np.int64)
            line[moved] = self.order[pick, c]
            out[:, i] = lines[line, cycles[i]]
        return out


def _records(ids, seq, qual, name, mate):
    ''' the FastQ bytes of one block: ``@<name>.<id, 9 digits><mate>`` '''
    n, length = seq.shape
    head = b'@' + name.encode() + b'.'
    tail = mate.encode()
    width = len(head) + 9 + len(tail) + 1 + length + 3 + length + 1
    out = np.empty((n, width), np.uint8)
    o = len(head)
    out[:, :o] = np.frombuffer(head, np.uint8)
    for k in range(9):
        out[:, o + k] = 48 + (ids // 10 ** (8 - k)) % 10
    o += 9
    out[:, o:o + len(tail)] = np.frombuffer(tail, np.uint8)
    o += len(tail)
    out[:, o] = 10
    out[:, o + 1:o + 1 + length] = BASES[seq]
    o += 1 + length
    out[:, o:o + 3] = np.frombuffer(b'\n+\n', np.uint8)
    out[:, o + 3:o + 3 + length] = qual
    out[:, -1] = 10
    return out.tobytes()


def _regions(rng, n, size, panel, off_target):
    ''' per read or pair, the first base and the length of the stretch
        it lies in: the whole strain without a panel; else the amplicon
        drawn for it, or the whole strain for the ``off_target`` share '''
    if panel is None:
        return 0, size
    first, lens = panel
    pick = np.searchsorted(np.cumsum(lens), rng.random(n) * lens.sum(),
                           'right')
    off = rng.random(n) < off_target
    return (np.where(off, 0, first[pick]), np.where(off, size, lens[pick]))


def _block(g, reads, model, quals, seq_seed, lo, hi, name, panel=None):
    ''' the FastQ bytes of reads (or pairs) lo..hi, one entry per file '''
    rng = np.random.Generator(np.random.PCG64(seq_seed))
    n = hi - lo
    length = reads['read_length']
    ids = np.arange(lo, hi, dtype=np.int64)
    minus = rng.random(n) < 0.5
    first, span = _regions(rng, n, len(g), panel,
                           reads.get('off_target', 0))
    if reads['layout'] == 'single':
        starts = first + rng.integers(0, span - length + 1, n)
        mates = [_reads(g, starts, minus, length)]
        suffixes = ['']
    else:
        f = reads['fragment']
        frag = np.rint(rng.normal(f['mean'], f['sd'], n))
        frag = np.minimum(np.maximum(frag, max(length, f['min'])),
                          np.minimum(f['max'], span)).astype(np.int64)
        starts = first + rng.integers(0, span - frag + 1)
        head = _reads(g, starts, np.zeros(n, bool), length)
        end = _reads(g, starts + frag - length, np.ones(n, bool), length)
        # mates read inward from both ends; a fragment of the minus
        # strand is read from its other end first
        mates = [np.where(minus[:, None], end, head),
                 np.where(minus[:, None], head, end)]
        suffixes = ['/1', '/2']
    out = []
    for seq, mate in zip(mates, suffixes):
        _errors(seq, model['error_rate'], rng)
        out.append(_records(ids, seq, quals.draw(n, rng), name, mate))
    return out


def panel_arrays(reads, size):
    ''' (0-based first bases, lengths) of ``reads['panel']``, None
        without one; an amplicon outside the genome of ``size`` bases, or
        shorter than a read, is an error that names it '''
    if reads.get('panel') is None:
        return None
    first, lens = [], []
    for k, (start, stop) in enumerate(reads['panel']):
        if not 1 <= start <= stop <= size:
            raise ValueError('amplicon %d [%d, %d] is not inside the genome '
                             'of %d bases' % (k, start, stop, size))
        if stop - start + 1 < reads['read_length']:
            raise ValueError('amplicon %d [%d, %d] is shorter than a read '
                             '(%d bases)' % (k, start, stop,
                                             reads['read_length']))
        first.append(start - 1)
        lens.append(stop - start + 1)
    return np.array(first, np.int64), np.array(lens, np.int64)


def panel_around(spans, flank):
    ''' amplicons ``[start, stop]`` around ``spans`` (1-based, inclusive):
        each widened by ``flank`` bases on both sides, merged where they
        overlap or touch '''
    out = []
    for a, b in sorted(spans):
        a, b = a - flank, b + flank
        if out and a <= out[-1][1] + 1:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def sample_paths(outdir, name, reads):
    ''' the files of sample ``name``: the path to scan first '''
    if reads['layout'] == 'single':
        ext = '.fastq.gz' if reads['compression'] == 'gzip' else '.fastq'
        return [os.path.join(outdir, name + ext)]
    ext = '.fastq.gz' if reads['compression'] == 'gzip' else '.fastq'
    return [os.path.join(outdir, '%s_%d%s' % (name, m, ext)) for m in (1, 2)]


def reads_per_sample(reads):
    ''' the reads a sample holds, a mate counting as a read '''
    mates = 1 if reads['layout'] == 'single' else 2
    return reads['count'] * mates


def quality_lines(config, root=None):
    ''' the configuration's model of qualities '''
    model = config['model']
    return QualityLines(os.path.join(root or ROOT, model['qualities']),
                        config['reads']['read_length'],
                        model['quality_switch'])


def make_sample(genome_codes, group, config, seed, index, outdir,
                threads=8, quals=None):
    ''' write sample ``index`` of ``seed``; :returns: (its paths, the
        planted substitutions) '''
    reads, model = config['reads'], config['model']
    if quals is None:
        quals = quality_lines(config)
    root = np.random.SeedSequence([seed & 0xFFFFFFFF, seed >> 32, index])
    strain_seq, read_seq = root.spawn(2)
    g, planted = strain(genome_codes, group, model,
                        np.random.Generator(np.random.PCG64(strain_seq)))
    name = 's%d' % index
    paths = sample_paths(outdir, name, reads)
    total = reads['count']
    bounds = [(lo, min(total, lo + BLOCK)) for lo in range(0, total, BLOCK)]
    seqs = read_seq.spawn(len(bounds))
    level = reads.get('gzip_level')
    panel = panel_arrays(reads, len(g))

    def work(k):
        blocks = _block(g, reads, model, quals, seqs[k], *bounds[k], name,
                        panel)
        if reads['compression'] == 'gzip':
            blocks = [gzip.compress(b, compresslevel=level, mtime=0)
                      for b in blocks]
        return blocks

    files = [open(p, 'wb') for p in paths]
    try:
        with ThreadPoolExecutor(max_workers=threads) as pool:
            for blocks in pool.map(work, range(len(bounds))):
                for fd, b in zip(files, blocks):
                    fd.write(b)
    finally:
        for fd in files:
            fd.close()
    return paths, planted


def genome_codes(path):
    with open(path, 'rb') as fd:
        return _CODE[np.frombuffer(fd.read().strip(), np.uint8)]
