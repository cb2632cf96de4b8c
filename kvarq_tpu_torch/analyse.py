'''
Scan orchestration and the versioned ``.json`` result format (the port's
copy of kvarq_tpu/analyse.py; :py:meth:`Analyser.scan` runs the port's
engine).

:py:class:`Coverage` turns engine hits (or device-side base-count tensors)
into per-position depth + alternate-base records; :py:class:`Analyser`
drives a scan, hands coverages to the testsuites and round-trips
everything through the result format.  Formulas and the serialized format
match reference kvarq/analyse.py exactly (citations inline), including the
documented quirks (``std`` always sums the full array; mutation strings
serialize base-sorted).
'''

import codecs
import json
import os.path
import sys
import time
from collections import Counter, OrderedDict

from kvarq_tpu_torch import VERSION, engine, genes
from kvarq_tpu_torch.config import default_config
from kvarq_tpu_torch.fastq import Fastq
from kvarq_tpu_torch.legacy import convert_legacy_data
from kvarq_tpu_torch.log import format_traceback, lo, tictoc
from kvarq_tpu_torch.versions import StrictVersion


class DecodingException(Exception):
    ''' raised when :py:class:`Analyser` data cannot be decoded '''


class VersionConflictException(DecodingException):
    ''' file version incompatible with this KvarQ version '''


class TestsuiteVersionConflictException(DecodingException):
    ''' testsuite versions in .json incompatible with loaded testsuites '''


class DataInconcistencyException(DecodingException):
    ''' inconsistency in decoded data '''


def template_sequence(template, spacing):
    ''' the scan sequence of a template: dynamic templates get ``spacing``
        bases of flank on both sides '''
    if isinstance(template, genes.DynamicTemplate):
        return template.seq(spacing=spacing)
    return template.seq()


class Coverage:

    '''
    Per-template scan outcome: ``coverage[i]`` is the read depth at
    position ``i`` (counted from the first base of the left flank) and
    ``mutations[i]`` a string of every alternate base observed there.
    ``start``/``stop`` delimit the region of interest between the flanks.
    Semantics per reference analyse.py:25-186.
    '''

    def __init__(self, plus_seq):
        self.plus_seq = plus_seq
        self.minus_seq = plus_seq.reverse()
        self.coverage = [0] * len(plus_seq)
        self.mutations = {}
        self.start = plus_seq.left
        self.stop = len(plus_seq) - plus_seq.right

    def _roi(self, include_margins):
        ''' (start, stop) of the positions a statistic runs over '''
        if include_margins:
            return 0, len(self.coverage)
        return self.start, self.stop

    # --- accumulation ------------------------------------------------------

    def apply_hit(self, hit, hitseq, on_plus_strand):
        ''' walk one hit's overlap, mapping minus-strand positions/bases
            back onto the + strand (reference analyse.py:57-78) '''
        seq = self.plus_seq if on_plus_strand else self.minus_seq
        offset = max(0, hit.seq_pos)
        for i in range(hit.length):
            read_base = hitseq[i]
            j = offset + i
            plus_j = seq.plus_idx(j)
            self.coverage[plus_j] += 1
            if read_base != seq[j]:
                self.mutations[plus_j] = (self.mutations.get(plus_j, '')
                                          + seq.plus_base(read_base))

    # --- statistics ----------------------------------------------------------

    def bases_at(self, idx):
        ''' observed base -> count at ``idx`` (template base included) '''
        alternates = Counter(self.mutations.get(idx, ''))
        counts = {self.plus_seq[idx]:
                  self.coverage[idx] - sum(alternates.values())}
        counts.update(alternates)
        return counts

    def fractions_at(self, idx):
        ''' base -> fraction at ``idx``, most prevalent first (ties broken
            deterministically, unlike the Python-2 reference's hash
            order) '''
        counts = self.bases_at(idx)
        denominator = float(max(1, sum(counts.values())))
        ranked = sorted(counts.items(), key=lambda item: -item[1])
        return OrderedDict((base, n / denominator) for base, n in ranked)

    def minf(self, include_margins=False):
        ''' minimum (over positions) fraction of the dominant base '''
        start, stop = self._roi(include_margins)
        return min(next(iter(self.fractions_at(pos).values()))
                   for pos in range(start, stop))

    def mixed(self, fmin=0.9, include_margins=False):
        ''' some covered position has its dominant base below ``fmin`` '''
        dominant = self.minf(include_margins=include_margins)
        return 0 < dominant < fmin

    def mean(self, include_margins=True):
        start, stop = self._roi(include_margins)
        return sum(self.coverage[start:stop]) / float(stop - start)

    def std(self, include_margins=True):
        ''' standard deviation of depth.  Faithfully reproduces the
            reference quirk (analyse.py:134-144): regardless of
            ``include_margins`` the sum runs over the *full* array around
            the full-array mean. '''
        m = self.mean()
        variance = sum((x - m) ** 2 for x in self.coverage)
        return (variance / len(self.coverage)) ** .5

    def seqmean(self):
        ''' mean depth over the region of interest, *not* counting reads
            that diverge from the template '''
        clean = [self.coverage[i] - len(self.mutations.get(i, ''))
                 for i in range(self.start, self.stop)]
        return sum(clean) / float(len(clean))

    # --- (de)serialization -----------------------------------------------------

    def serialize(self):
        ''' the exact string format stored in .json files (reference
            analyse.py:157-164): '-'-joined depths, one space, '-'-joined
            ``idx[sorted bases]`` mutation entries '''
        depths = '-'.join(map(str, self.coverage))
        entries = ('%d[%s]' % (idx, ''.join(sorted(bases)))
                   for idx, bases in sorted(self.mutations.items()))
        return depths + ' ' + '-'.join(entries)

    def deserialize(self, serialized):
        depths, _, entries = serialized.partition(' ')
        self.coverage = [int(d) for d in depths.split('-')]
        self.mutations = {}
        if entries:
            for entry in entries.split('-'):
                idx, _, bases = entry.partition('[')
                self.mutations[int(idx)] = bases.rstrip(']')

    def __str__(self):
        return '(mean %.2f std %.2f) ' % (self.mean(), self.std()) \
            + ' ' + self.serialize()

    def __len__(self):
        return len(self.coverage)

    def __getitem__(self, idx):
        return self.coverage[idx]


class Analyser:

    '''
    Lifecycle (reference analyse.py:207-258): ``scan()`` runs the engine
    and fills ``.coverages`` (an OrderedDict ``str(template) -> Coverage``,
    shared templates deduped); ``update_testsuites()`` produces
    ``.results``; ``encode()``/``decode()`` round-trip everything through
    the versioned .json format.  Coverages are also retrievable by scan
    index (reverse strand = index + number of templates) or by
    :py:class:`kvarq_tpu_torch.genes.Test`.
    '''

    def __init__(self):
        self.config = None
        self.fastq = None
        self.fastq_filenames = None
        self.fastq_sizes = None
        self.fastq_readlength = None
        self.fastq_records_approx = None
        self.spacing = default_config['spacing']

        self.hits = None
        self.hitseqs = None
        self.stats = None
        self.scantime = 0
        self.phases = None      # optional per-phase timing (--profile)
        self.coverages = None
        self.results = None

    # --- coverage lookup ----------------------------------------------------

    def load_coverages(self, testsuites, spacing):
        ''' fresh Coverage per distinct template over all testsuites
            (reference analyse.py:260-282) '''
        coverages = OrderedDict()
        for testsuite in testsuites.values():
            for test in testsuite.tests:
                coverages[str(test.template)] = Coverage(
                    template_sequence(test.template, spacing))
        return coverages

    def _ordered_names(self):
        return list(self.coverages.keys())

    def coverage_at(self, i):
        ''' coverage by scan index; indices >= len(coverages) refer to the
            reverse strand of the same template (analyse.py:284-294) '''
        return self.coverages[self._ordered_names()[i % len(self.coverages)]]

    def get_indexes(self, thing):
        ''' [forward_index, reverse_index] for a test or template name '''
        key = str(thing.template) if isinstance(thing, genes.Test) \
            else thing
        forward = self._ordered_names().index(key)
        return [forward, forward + len(self.coverages)]

    def __len__(self):
        return len(self.coverages)

    def __getitem__(self, thing):
        if type(thing) == int:
            return self.coverage_at(thing)
        if isinstance(thing, genes.Test):
            return self.coverages[str(thing.template)]
        return self.coverages[str(thing)]

    # --- scanning ---------------------------------------------------------------

    def _record_fastq(self, fastq):
        self.fastq = fastq
        self.fastq_filenames = fastq.filenames()
        self.fastq_sizes = fastq.filesizes()
        self.fastq_readlength = fastq.readlength
        self.fastq_records_approx = fastq.records_approx

    def scan(self, fastq, testsuites, do_reverse=True, keep_hits=True):
        ''' scan ``fastq`` against every template's plus (and minus)
            sequence and fill ``.coverages`` (reference analyse.py:328-365).

            With ``keep_hits`` (the default, the reference behavior) the
            engine materializes the full hit list
            (:py:func:`kvarq_tpu_torch.engine.findseqs`) so
            ``-H``/``--extract-hits`` work.  With ``keep_hits=False``
            :py:func:`kvarq_tpu_torch.engine.countseqs` accumulates the
            base counts on the device, with no host hit list: identical
            coverages/stats/results.  ``self.config`` is the engine's
            configuration, which the result json records. '''
        self._record_fastq(fastq)
        self.testsuites = testsuites
        self.coverages = self.load_coverages(testsuites,
                                             spacing=self.spacing)
        self.config = engine.get_config()

        seqs = [c.plus_seq.bases for c in self.coverages.values()]
        if do_reverse:
            seqs += [c.minus_seq.bases for c in self.coverages.values()]

        started = time.time()
        if keep_hits:
            ret = engine.findseqs(self.fastq.filenames(), seqs)
            lo.debug('found %d hits' % len(ret['hits']))
            self.stats = ret['stats']
            self.hits = ret['hits']
            self.hitseqs = ret['hitseqs']
            self.scantime = time.time() - started
            self.update_coverages()
        else:
            from kvarq_tpu_torch.engine.encode import fold_into_coverage
            ret = engine.countseqs(self.fastq.filenames(), seqs)
            self.stats = ret['stats']
            self.hits = self.hitseqs = None
            n = len(self.coverages)
            counts = ret['basecounts']
            for i, coverage in enumerate(self.coverages.values()):
                fold_into_coverage(
                    coverage, counts[i],
                    counts[n + i] if do_reverse else None)
            self.scantime = time.time() - started

    @tictoc('update_coverages')
    def update_coverages(self):
        ''' replay ``.hits`` into ``.coverages``; strand demultiplexed by
            ``seq_nr`` (analyse.py:368-381) '''
        assert self.hits is not None, 'cannot update coverages without .hits'
        assert self.hitseqs is not None, \
            'cannot update coverages without .hitseqs'
        assert self.fastq is not None, 'cannot update coverages without .fastq'

        n = len(self.coverages)
        for hit, hitseq in zip(self.hits, self.hitseqs):
            self.coverage_at(hit.seq_nr).apply_hit(
                hit, hitseq, on_plus_strand=hit.seq_nr < n)

    def update_testsuites(self):
        ''' run every testsuite's analysis, trapping per-testsuite errors
            into 'ERROR : ...' result strings (analyse.py:384-395) '''
        self.results = {}
        for name, testsuite in self.testsuites.items():
            try:
                self.results[name] = testsuite.analyse(self)
            except Exception as e:
                lo.error('testsuite "%s" : %s [%s]'
                         % (name, e, format_traceback(sys.exc_info())))
                self.results[name] = 'ERROR : ' + str(e)

    # --- result format -------------------------------------------------------------

    def _info_block(self):
        info = {
            'format': 'kvarq',
            'fastq': self.fastq_filenames,
            'size': self.fastq_sizes,
            'readlength': self.fastq_readlength,
            'records_approx': self.fastq_records_approx,
            'scantime': self.scantime,
            'when': time.asctime(time.localtime()),
            'version': VERSION,
            'config': self.config,
            'spacing': self.spacing,
            'testsuites': {name: testsuite.version
                           for name, testsuite in self.testsuites.items()},
        }
        if self.phases:
            # per-phase wall clock recorded under --profile
            # (kvarq_tpu_torch.profiling); absent otherwise for schema parity
            info['phases'] = self.phases
        return info

    @tictoc('encode')
    def encode(self, hits=False):
        ''' json-able dict: analyses/info/stats/coverages[/hits,hitseqs]
            (analyse.py:397-435) '''
        data = dict(
            analyses=self.results,
            info=self._info_block(),
            stats=self.stats,
            coverages=[(name, coverage.serialize())
                       for name, coverage in self.coverages.items()])
        if hits:
            data['hits'] = self.hits
            data['hitseqs'] = self.hitseqs
        return data

    def _restore_metadata(self, data):
        info = data['info']
        self.config = info['config']
        self.fastq_filenames = info['fastq']
        self.fastq_sizes = info['size']
        self.fastq_readlength = info.get('readlength', -1)
        self.fastq_records_approx = info.get('records_approx', -1)
        self.scantime = info.get('scantime', -1)
        self.spacing = info['spacing']
        self.stats = data['stats']

        self.hits = None
        if 'hits' in data:
            self.hits = [engine.Hit(*hit) for hit in data['hits']]
        self.hitseqs = data.get('hitseqs')

        self.fastq = None
        if os.path.isfile(self.fastq_filenames[0]):
            lo.info('found .fastq file : ' + self.fastq_filenames[0])
            self.fastq = Fastq(self.fastq_filenames[0])
        else:
            lo.info('cannot load .fastq file : ' + self.fastq_filenames[0])

    def _gate_testsuites(self, testsuites, names_versions):
        ''' keep the loaded testsuites named in the json, requiring
            json version <= loaded version with equal major '''
        self.testsuites = {}
        for name, version in names_versions.items():
            if name not in testsuites:
                lo.warning('testsuite "%s" not loaded -> ignoring some '
                           'results in .json file' % name)
                continue
            testsuite = testsuites[name]
            json_v = StrictVersion(version)
            kvarq_v = StrictVersion(testsuite.version)
            if json_v > kvarq_v or json_v.version[0] != kvarq_v.version[0]:
                raise TestsuiteVersionConflictException(
                    'version conflict testsuite "%s" : .json version '
                    '"%s" not compatible with current version "%s"'
                    % (name, version, testsuite.version))
            lo.debug('loading testsuite %s (%s)' % (name, str(testsuite)))
            self.testsuites[name] = testsuite

    def _rebuild_coverages(self, testsuites, serialized_coverages):
        ''' deserialize coverages against the loaded templates, silently
            dropping templates no longer defined '''
        templates = {str(test.template): test.template
                     for testsuite in testsuites.values()
                     for test in testsuite.tests}
        self.coverages = OrderedDict()
        for name, serialized in serialized_coverages:
            template = templates.get(name)
            if template is None:
                continue  # newer testsuites may have discarded tests
            coverage = Coverage(template_sequence(template, self.spacing))
            coverage.deserialize(serialized)
            self.coverages[name] = coverage

    @tictoc('decode')
    def decode(self, testsuites, data):
        ''' inverse of :py:meth:`encode`, with legacy format conversion and
            per-testsuite version gates (analyse.py:438-534) '''
        data = convert_legacy_data(testsuites, data)
        self._restore_metadata(data)
        self._gate_testsuites(testsuites, data['info']['testsuites'])
        self._rebuild_coverages(testsuites, data['coverages'])

    @tictoc('extract_hits')
    def extract_hits(self, fname):
        ''' write the full FastQ records of all hits to ``fname`` '''
        with open(fname, 'w') as out:
            for hit in self.hits:
                out.write(self.fastq.readrecordat(hit))


class AnalyserJson:

    ''' validates/loads .json files created by Analyser.encode()
        (reference analyse.py:543-574) '''

    def __init__(self, jpath, minver=None):
        try:
            self.data = json.load(codecs.open(jpath, encoding='utf-8'))
        except ValueError as e:
            raise DecodingException('not valid .json format : ' + str(e))

        info = self.data.get('info')
        if info is None:
            raise DecodingException(
                'not valid file format : "info" key missing')
        if info.get('format') != 'kvarq':
            raise DecodingException(
                'not valid file format : "info"/"format" != "kvarq"')

        if minver:
            dataversion = StrictVersion(info['version'])
            if dataversion < StrictVersion(minver):
                raise VersionConflictException(
                    '.json format too old : %s < %s'
                    % (dataversion, StrictVersion(minver)))

    @property
    def analyses(self):
        return self.data['analyses'].items()
