'''
The plain NumPy reference of a KvarQ scan: from the FastQ bytes to the
result a ``kvarq scan`` writes (coverages, calls, statistics and, for a
hit scan, every hit), by the published semantics and nothing of the
program under test.

- Reading: gzip members inflated by :py:mod:`gzip`; the files of a pair
  read one after the other as one stream, so a read's file position
  counts from the start of the first file.
- Quality trimming: a read is the first of the longest runs of quality
  bytes at or above ``Amin``; every record counts in the read-length
  histogram, and reads shorter than the minimum read length are dropped.
- Matching: ungapped alignments of a read against every template window,
  both strands, with at most ``maxerrors`` mismatching bytes over the
  overlap, in KvarQ's four modes (read tail over the template's head,
  read head over its tail, template inside the read, read inside the
  template), each mode's emission a hit of its own. Candidates come from
  exact k-mer seeds on one diagonal, with k and the seed count chosen by
  the q-gram lemma so that no alignment within the limits is missed;
  each candidate is then checked base by base.
- Coverage: each hit adds its overlap to the depth of the plus strand
  and every differing read base (complemented on the minus strand) as
  an alternate at its position.
'''

import gzip
from concurrent.futures import ThreadPoolExecutor

import numpy as np

MAX_READLENGTH = 1024      # the read-length histogram's last bin
NL, AT, PLUS = 10, ord('@'), ord('+')

_CODE = np.full(256, 4, np.uint8)
for _i, _c in enumerate(b'ACGT'):
    _CODE[_c] = _i
# a read byte as the plus strand reads it where a minus-strand template
# met it: A, C, G and T complemented, every other byte as it is
_COMPL_BYTE = np.arange(256, dtype=np.uint8)
for _a, _b in zip(b'ACGT', b'TGCA'):
    _COMPL_BYTE[_a] = _b


def read_stream(paths):
    ''' the decompressed bytes of ``paths``, one after the other '''
    parts = []
    for path in paths:
        with open(path, 'rb') as fd:
            data = fd.read()
        if data[:2] == b'\x1f\x8b':
            data = gzip.decompress(data)
        parts.append(data)
    return parts[0] if len(parts) == 1 else b''.join(parts)


class Records:
    ''' the records of a stream: every record's trimmed length, and the
        kept reads' file positions and lengths '''

    def __init__(self, buf, amin, minreadlength, chunk=1 << 16, threads=8):
        arr = np.frombuffer(buf, np.uint8)
        nl = np.flatnonzero(arr == NL)
        n = len(nl) // 4
        nl = nl[:4 * n].reshape(n, 4)
        rec0 = np.concatenate([[0], nl[:-1, 3] + 1]) if n else nl[:, 0]
        if n and ((arr[rec0] != AT).any() or (arr[nl[:, 1] + 1] != PLUS).any()):
            raise ValueError('not a FastQ stream of four-line records')
        self.buf, self.arr = buf, arr
        self.n = n
        rl = np.zeros(n, np.int64)
        off = np.zeros(n, np.int64)

        def trim(lo):
            hi = min(n, lo + chunk)
            rl[lo:hi], off[lo:hi] = _trim(arr, nl[lo:hi, 2] + 1,
                                          nl[lo:hi, 3], amin)
        with ThreadPoolExecutor(max_workers=threads) as pool:
            list(pool.map(trim, range(0, n, chunk)))
        self.histogram = np.bincount(np.minimum(rl, MAX_READLENGTH - 1),
                                     minlength=MAX_READLENGTH)
        self.longest = int(min(rl.max(), MAX_READLENGTH - 1)) if n else -1
        keep = (rl >= minreadlength) & (rl > 0)
        self.rl = rl[keep]
        self.pos = (nl[:, 0] + 1 + off)[keep]

    def codes(self, lo, hi, width):
        ''' [hi - lo, width] base codes of kept reads lo..hi (A C G T as
            0..3; N, other bytes and the padding past a read's end as 4) '''
        idx = self.pos[lo:hi, None] + np.arange(width)
        inside = np.arange(width) < self.rl[lo:hi, None]
        out = _CODE[self.arr[np.minimum(idx, len(self.arr) - 1)]]
        out[~inside] = 4
        return out

    def reads(self, r, start, length):
        ''' the bases of each kept read ``r[k]`` from ``start[k]`` on, for
            ``length[k]`` bases, as text '''
        buf = self.buf
        return [buf[p:p + n].decode('latin-1') for p, n in
                zip((self.pos[r] + start).tolist(), length.tolist())]


def _trim(arr, qs, qe, amin):
    ''' (length, offset) of the first longest run of quality bytes >= amin
        of each quality line ``arr[qs:qe]`` '''
    qlen = qe - qs
    width = int(qlen.max()) if len(qlen) else 0
    cols = np.arange(width)
    good = np.zeros((len(qs), width + 2), bool)
    if width:
        idx = np.minimum(qs[:, None] + cols, len(arr) - 1)
        good[:, 1:-1] = (arr[idx] >= amin) & (cols < qlen[:, None])
    step = np.diff(good.view(np.int8).ravel())
    starts = np.flatnonzero(step == 1) + 1
    ends = np.flatnonzero(step == -1) + 1
    span = width + 2
    row, col = starts // span, starts % span - 1
    length = ends - starts
    # longest first, then earliest
    key = length * (span + 1) + (span - col)
    best = np.zeros(len(qs), np.int64)
    np.maximum.at(best, row, key)
    rl = best // (span + 1)
    off = np.where(rl > 0, span - best % (span + 1), 0)
    return rl, off


class Templates:
    ''' the scanned sequences, their codes and an index of their k-mers '''

    def __init__(self, seqs, maxerrors, minoverlap, minreadlength):
        if not set(''.join(seqs)) <= set('ACGT'):
            raise ValueError('the reference takes A, C, G and T templates')
        self.seqs = seqs
        self.lens = np.array([len(s) for s in seqs], np.int64)
        self.base = np.concatenate([[0], np.cumsum(self.lens + 1)])[:-1]
        joined = '|'.join(seqs).encode('latin-1')
        self.codes = _CODE[np.frombuffer(joined, np.uint8)]
        self.e = maxerrors
        self.mo = minoverlap
        # every alignment with weight overlaps by m or more with at most e
        # mismatches; each mismatch spoils k seeds of the m - k + 1
        m = max(1, min(minoverlap, minreadlength, int(self.lens.min())))
        self.k = k = max(1, min(12, m // (maxerrors + 1)))
        self.need = m - k + 1 - maxerrors * k
        assert self.need >= 1
        kmer, valid = _kmers(self.codes[None, :], k)
        pos = np.flatnonzero(valid[0])
        kmer = kmer[0, pos]
        tid = np.searchsorted(self.base, pos, side='right') - 1
        order = np.argsort(kmer, kind='stable')
        self.k_t = tid[order]
        self.k_p = (pos - self.base[tid])[order]
        self.k_start = np.searchsorted(kmer[order], np.arange(4 ** k + 1))


def _kmers(codes, k):
    ''' the 2-bit code of the k-mer at every start of each row, and
        whether it holds A, C, G and T only '''
    w = codes.shape[1] - k + 1
    if w <= 0:
        return (np.zeros((len(codes), 0), np.int64),
                np.zeros((len(codes), 0), bool))
    kmer = np.zeros((len(codes), w), np.int32 if k <= 15 else np.int64)
    bad = np.zeros((len(codes), w), bool)
    for j in range(k):
        c = codes[:, j:j + w]
        kmer <<= 2
        kmer |= c & 3
        bad |= c > 3
    return kmer, ~bad


def weights(d, rl, seql, mo):
    ''' per (read length, template length, shift d), how many of KvarQ's
        modes emit the alignment: A (read tail over template head), B (read
        head over template tail), C (template inside the read) and D (read
        inside the template); B and D both emit where the read ends at the
        template's end '''
    ab = (rl > mo) & (seql > mo)
    a = ab & (d < 0) & (-d >= np.maximum(1, rl - seql + 1)) & (-d <= rl - mo)
    b = ab & (d > 0) & (d >= np.maximum(1, seql - rl)) & (d <= seql - mo)
    c = (rl > seql) & (d <= 0) & (-d <= rl - seql)
    dd = (rl <= seql) & (d >= 0) & (d <= seql - rl)
    return a, b, c, dd


def _match_chunk(rec, tpl, lo, hi):
    ''' (read, template, shift, mismatches) of every alignment of kept
        reads lo..hi within the error limit '''
    width = int(rec.rl[lo:hi].max())
    codes = rec.codes(lo, hi, width)
    kmer, valid = _kmers(codes, tpl.k)
    r_i, i_i = np.nonzero(valid)
    kc = kmer[r_i, i_i]
    first = tpl.k_start[kc]
    cnt = tpl.k_start[kc + 1] - first
    total = int(cnt.sum())
    empty = np.zeros((0, 4), np.int64)
    if not total:
        return empty
    rep = np.repeat(np.arange(len(kc)), cnt)
    within = np.arange(total) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    e = first[rep] + within
    t = tpl.k_t[e]
    d = tpl.k_p[e] - i_i[rep]
    r = r_i[rep]
    span = width + int(tpl.lens.max()) + 1
    key = (r * len(tpl.seqs) + t) * span + (d + width)
    key, n = np.unique(key, return_counts=True)
    key, n = key[n >= tpl.need], n[n >= tpl.need]
    d = key % span - width
    t = key // span % len(tpl.seqs)
    r = key // span // len(tpl.seqs)
    rl = rec.rl[lo + r]
    seql = tpl.lens[t]
    w = sum(m.astype(np.int64) for m in weights(d, rl, seql, tpl.mo))
    jlo = np.maximum(0, d)
    jhi = np.minimum(seql, d + rl)
    # the lemma on this alignment's own overlap: its seeds number at least
    # ov - k + 1 - k * e
    keep = (w > 0) & (n >= jhi - jlo - tpl.k + 1 - tpl.k * tpl.e)
    r, t, d, seql, jlo, jhi = (x[keep] for x in (r, t, d, seql, jlo, jhi))
    if not len(r):
        return empty
    cols = np.arange(width)
    j = jlo[:, None] + cols
    inside = j < jhi[:, None]
    read_c = codes[r[:, None], np.clip(j - d[:, None], 0, width - 1)]
    tmpl_c = tpl.codes[tpl.base[t][:, None] + np.minimum(j, seql[:, None] - 1)]
    mism = ((read_c != tmpl_c) & inside).sum(axis=1)
    keep = mism <= tpl.e
    return np.stack([r[keep] + lo, t[keep], d[keep], mism[keep]], axis=1)


def match(rec, tpl, threads=8, chunk=1 << 15):
    ''' every alignment of every kept read within the error limit, as
        [K, 4] (read, template, shift, mismatches) rows '''
    bounds = [(lo, min(len(rec.rl), lo + chunk))
              for lo in range(0, len(rec.rl), chunk)]
    with ThreadPoolExecutor(max_workers=threads) as pool:
        parts = list(pool.map(lambda b: _match_chunk(rec, tpl, *b), bounds))
    parts = [p for p in parts if len(p)]
    return np.concatenate(parts) if parts else np.zeros((0, 4), np.int64)


def emit(rec, tpl, trip):
    ''' the hits of ``trip`` in KvarQ's order (read, then template, then
        mode A by shift ascending, B by shift descending, C and D by their
        offset) as (read, template, shift, length) rows '''
    r, t, d = trip[:, 0], trip[:, 1], trip[:, 2]
    rl, seql = rec.rl[r], tpl.lens[t]
    a, b, c, dd = weights(d, rl, seql, tpl.mo)
    modes = [(a, 0, d, rl + d), (b, 1, -d, seql - d), (c, 2, -d, seql),
             (dd, 2, d, rl)]
    idx = np.concatenate([np.flatnonzero(m) for m, _, _, _ in modes])
    rank = np.concatenate([np.full(int(m.sum()), k) for m, k, _, _ in modes])
    key = np.concatenate([x[m] for m, _, x, _ in modes])
    length = np.concatenate([x[m] for m, _, _, x in modes])
    order = np.lexsort((key, rank, t[idx], r[idx]))
    idx, length = idx[order], length[order]
    return np.stack([r[idx], t[idx], d[idx], length], axis=1)


class Coverage:
    ''' depth and alternates of one window, on its plus strand '''

    def __init__(self, plus, start, stop):
        self.plus = plus
        self.start, self.stop = start, stop
        self.coverage = [0] * len(plus)
        self.mutations = {}          # position -> {base: count}
        self.mutation_order = []     # positions, in the order first seen

    def serialize(self):
        depths = '-'.join(map(str, self.coverage))
        entries = ('%d[%s]' % (i, ''.join(b * n for b, n in
                                          sorted(self.mutations[i].items())))
                   for i in sorted(self.mutations))
        return depths + ' ' + '-'.join(entries)

    def alternates(self, i):
        return sum(self.mutations.get(i, {}).values())

    def dominant_fraction(self, i):
        counts = [self.coverage[i] - self.alternates(i)]
        counts += list(self.mutations.get(i, {}).values())
        return max(counts) / float(max(1, sum(counts)))

    def minf(self):
        return min(self.dominant_fraction(i)
                   for i in range(self.start, self.stop))

    def mixed(self, fmin=0.9):
        return 0 < self.minf() < fmin

    def mean(self, include_margins=True):
        a, b = (0, len(self.coverage)) if include_margins \
            else (self.start, self.stop)
        return sum(self.coverage[a:b]) / float(b - a)

    def std(self):
        # over the whole window, as KvarQ computes it whatever the margins
        m = self.mean()
        return (sum((x - m) ** 2 for x in self.coverage)
                / len(self.coverage)) ** .5


def coverages(rec, tpl, hits, windows, hit_order, chunk=1 << 15):
    ''' ``{window name: Coverage}`` from ``hits`` over ``windows`` (the
        plus strands, in order; minus-strand templates follow them). With
        ``hit_order`` the alternates are kept in the order the hits meet
        them, else by position.

        Depth: each hit's stretch on the plus strand, added up as
        differences in one array of every window. Alternates: the hits'
        read bases against their templates', ``chunk`` hits at a time,
        each differing base kept with its window, plus-strand position
        and base (complemented on the minus strand), hit by hit and base
        by base; the counts, each position's first sighting and each
        base's within it follow from that order. '''
    names = list(windows)
    nwin = len(names)
    cov = {n: Coverage(w.plus, w.start, w.stop) for n, w in windows.items()}
    r, t, d, length = (hits[:, k].astype(np.int64) for k in range(4))
    w = t % nwin
    plus = t < nwin
    S = tpl.lens[t]
    j0 = np.maximum(0, d)
    lens = np.array([len(x.plus) for x in windows.values()], np.int64)
    # a window's depths and one slot past it, where its differences end
    off = np.concatenate([[0], np.cumsum(lens + 1)])
    first = off[w] + np.where(plus, j0, S - j0 - length)
    depth = np.cumsum(np.bincount(first, minlength=off[-1])
                      - np.bincount(first + length, minlength=off[-1]))
    for k, n in enumerate(names):
        cov[n].coverage = depth[off[k]:off[k] + lens[k]].tolist()
    # each hit's read bases and template codes as a row of the longest
    # hit's width, cut from the stream and the templates (padded past
    # their ends, where the mask drops the bases)
    width = int(length.max()) if len(hits) else 0
    at = rec.pos[r] + np.maximum(0, -d)
    stream = rec.arr
    if len(hits) and int(at.max()) + width > len(stream):
        stream = np.concatenate([stream, np.zeros(width, np.uint8)])
    reads = np.lib.stride_tricks.sliding_window_view(stream, width)
    codes = np.lib.stride_tricks.sliding_window_view(
        np.concatenate([tpl.codes, np.full(width, 4, np.uint8)]), width)
    cols = np.arange(width)
    parts = []
    for a in range(0, len(hits), chunk):
        c = slice(a, a + chunk)
        inside = cols < length[c, None]
        x = reads[at[c]]
        y = codes[tpl.base[t[c]] + j0[c]]
        h, i = np.nonzero((_CODE[x] != y) & inside)
        base = x[h, i]
        h += a
        j = j0[h] + i
        parts.append(np.stack([w[h], np.where(plus[h], j, S[h] - 1 - j),
                               np.where(plus[h], base, _COMPL_BYTE[base])],
                              axis=1))
    alt = np.concatenate(parts) if parts else np.zeros((0, 3), np.int64)
    if not hit_order:
        alt = alt[np.lexsort((alt[:, 1], alt[:, 0]))]
    # (window, position, base) once each, in the order first met
    key = (alt[:, 0] * (int(tpl.lens.max()) + 1) + alt[:, 1]) * 256 \
        + alt[:, 2]
    _, seen, counts = np.unique(key, return_index=True, return_counts=True)
    order = np.argsort(seen)
    for (wk, j, base), n in zip(alt[seen[order]].tolist(),
                                counts[order].tolist()):
        c = cov[names[wk]]
        if j not in c.mutations:
            c.mutations[j] = {}
            c.mutation_order.append(j)
        c.mutations[j][chr(base)] = n
    return cov
