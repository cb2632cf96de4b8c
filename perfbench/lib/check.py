'''
What decides ``correct``: the result a scan wrote, held against the plain
reference's (:py:mod:`perfbench.lib.refengine`, with its matcher or the
brute-force one of :py:mod:`perfbench.lib.refexhaustive`, and the
configuration's testsuite group under ``perfbench/reference``), field by
field.

Every field is compared exactly (the system's counts are exact), so
each number compared counts differences and its limit is 0:

- ``missing``: scans that wrote no result;
- ``calls``: testsuite results that differ (the analyser layer);
- ``coverages``: windows whose depth or alternates differ (the engine:
  sieve, screen, exact scoring, the fold into coverage);
- ``stats``: statistics that differ (the host input: records parsed,
  read-length histogram, bytes, and the hits counted per template);
- ``hits``: hits or hit sequences that differ, or are missing or extra
  (hit scans: the extraction and ``_emit``);
- ``info``: result-header fields that differ (the files, their sizes,
  the scan's configuration).
'''

import os

import numpy as np

from perfbench.lib import refengine, refexhaustive

FIELDS = ('missing', 'calls', 'coverages', 'stats', 'hits', 'info')


# the seed length from which the k-mer seeds find the alignments fast
# on the host; below it (k 6 at e 3, 5 at e 4, overlap 25) a seed hits
# the templates about a thousand times a read, and the brute-force
# matcher is faster
SEED_MIN_K = 8


class Expected:
    ''' the reference's results for one sample: its reads parsed and
        matched once, the result of a coverage or a hit scan under the
        configuration's maxerrors or fewer (the control) on demand.

        The matcher: on a card (``device`` not the CPU), the brute-force
        one for every sample, whose time does not grow with the share of
        reads on a template (the seeded one's does: 34 us a read on an
        amplicon sample); on the CPU, the seeded one from seeds of
        ``SEED_MIN_K`` bases, the brute-force one below. Both give the
        same rows. '''

    def __init__(self, paths, config, group, device='cpu'):
        scan = config['scan']
        buf = refengine.read_stream(paths)
        self.rec = refengine.Records(buf, 33 + scan['quality'],
                                     scan['readlength'])
        self.tpl = refengine.Templates(group.sequences(), scan['errors'],
                                       scan['overlap'], scan['readlength'])
        if device == 'cpu' and self.tpl.k >= SEED_MIN_K:
            self.trip = refengine.match(self.rec, self.tpl)
        else:
            self.trip = refexhaustive.match(self.rec, self.tpl, device)
        self.group, self.paths, self.config = group, paths, config
        first = buf[:buf.find(b'\n', buf.find(b'\n') + 1)].split(b'\n')
        self.readlength = len(first[1].rstrip(b'\r')) if len(first) > 1 \
            else 0
        self.nbytes = len(buf)

    def result(self, hits, errors=None):
        ''' the result of a scan (``hits``: with ``-H``) where alignments
            of more than ``errors`` mismatches (the configuration's by
            default) are dropped '''
        if errors is None:
            errors = self.config['scan']['errors']
        rec, tpl, group = self.rec, self.tpl, self.group
        trip = self.trip[self.trip[:, 3] <= errors]
        found = refengine.emit(rec, tpl, trip)
        cov = refengine.coverages(rec, tpl, found, group.windows, hits)
        ntpl = len(tpl.seqs)
        nhits = np.bincount(found[:, 1], minlength=ntpl)
        nbases = np.bincount(found[:, 1], weights=found[:, 3],
                             minlength=ntpl)
        stats = {
            'readlengths': [int(x) for x in
                            rec.histogram[:rec.longest + 1]],
            'progress': 1.0 if self.nbytes else 0.0,
            'nseqbasehits': [int(x) for x in nbases],
            'nseqhits': [int(x) for x in nhits],
            'parsed': self.nbytes,
            'total': self.nbytes,
            'sigints': 0,
            'records_parsed': rec.n,
        }
        out = {
            'analyses': group.analyses(cov),
            'coverages': [[n, c.serialize()] for n, c in cov.items()],
            'stats': stats,
            'info': self._info(),
        }
        if hits:
            r, t, d, n = found.T
            out['hits'] = np.stack([t, rec.pos[r], d, n, rec.rl[r]],
                                   axis=1).tolist()
            out['hitseqs'] = rec.reads(r, np.maximum(0, -d), n)
        return out

    def _info(self):
        scan = self.config['scan']
        gz = self.paths[0].endswith('.gz')
        approx = None
        if not gz:
            # KvarQ's estimate: file size over the first record's size
            with open(self.paths[0], 'rb') as fd:
                per = len(b''.join(fd.readline() for _ in range(4)))
            approx = os.path.getsize(self.paths[0]) // per * len(self.paths)
        return {
            'format': 'kvarq',
            'fastq': list(self.paths),
            'size': [os.path.getsize(p) for p in self.paths],
            'readlength': self.readlength,
            'records_approx': approx,
            'config': {'maxerrors': scan['errors'],
                       'minoverlap': scan['overlap'],
                       'minreadlength': scan['readlength'],
                       'nthreads': scan['threads'],
                       'Amin': chr(33 + scan['quality']), 'Azero': '!'},
            'spacing': scan['spacing'],
            'testsuites': dict(self.group.versions),
        }


def compare(got, want):
    ''' ``{field: differences}`` of one scan's result against the
        reference's; ``got`` None is a scan that wrote nothing '''
    diff = dict.fromkeys(FIELDS, 0)
    if got is None:
        diff['missing'] = 1
        return diff
    wa, ga = want['analyses'], got.get('analyses') or {}
    diff['calls'] = sum(ga.get(k) != v for k, v in wa.items()) \
        + len(set(ga) - set(wa))
    wc, gc = want['coverages'], got.get('coverages') or []
    diff['coverages'] = sum(list(a) != list(b) for a, b in zip(wc, gc)) \
        + abs(len(wc) - len(gc))
    ws, gs = want['stats'], got.get('stats') or {}
    diff['stats'] = sum(_norm(gs.get(k)) != _norm(v) for k, v in ws.items())
    wi, gi = want['info'], got.get('info') or {}
    diff['info'] = sum(_norm(gi.get(k)) != _norm(v) for k, v in wi.items())
    if 'hits' in want:
        wh, gh = want['hits'], got.get('hits') or []
        wq, gq = want['hitseqs'], got.get('hitseqs') or []
        diff['hits'] = sum(list(a) != list(b) or x != y for a, b, x, y
                           in zip(wh, gh, wq, gq)) \
            + abs(len(wh) - len(gh)) + abs(len(wq) - len(gq))
    return diff


def _norm(value):
    ''' tuples as lists, as a result reads back from JSON '''
    if isinstance(value, (list, tuple)):
        return [_norm(v) for v in value]
    if isinstance(value, dict):
        return {k: _norm(v) for k, v in value.items()}
    return value
