'''
:py:class:`Analyser` of the port: ``kvarq_tpu.analyse.Analyser`` with a
``scan`` that runs :py:func:`kvarq_tpu_torch.engine.findseqs` or
:py:func:`kvarq_tpu_torch.engine.countseqs`.  Replaying hits into the
coverages, testsuite analysis, hit extraction and the result format are
inherited unchanged.
'''

import time

from kvarq_tpu import analyse
from kvarq_tpu.engine.tensor_scan import fold_into_coverage
from kvarq_tpu.log import lo
from kvarq_tpu_torch import engine


class Analyser(analyse.Analyser):

    def scan(self, fastq, testsuites, do_reverse=True, keep_hits=True):
        ''' scan ``fastq`` against every template's plus (and minus)
            sequence and fill ``.coverages``, as kvarq_tpu's ``scan``.
            With ``keep_hits`` (the default, as in kvarq_tpu) the port's
            :py:func:`~kvarq_tpu_torch.engine.findseqs` keeps the hit list
            (``.hits``/``.hitseqs``, for ``-H``/``-x``); without it
            :py:func:`~kvarq_tpu_torch.engine.countseqs` accumulates the
            base counts on the device.  ``self.config`` is the port
            engine's configuration, which the result json records. '''
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
            return
        ret = engine.countseqs(self.fastq.filenames(), seqs)
        self.stats = ret['stats']
        self.hits = self.hitseqs = None
        n = len(self.coverages)
        counts = ret['basecounts']
        for i, coverage in enumerate(self.coverages.values()):
            fold_into_coverage(coverage, counts[i],
                               counts[n + i] if do_reverse else None)
        self.scantime = time.time() - started
