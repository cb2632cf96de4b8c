'''
:py:class:`Analyser` of the port: ``kvarq_tpu.analyse.Analyser`` with a
``scan`` that runs :py:func:`kvarq_tpu_torch.engine.countseqs`.  Testsuite
analysis and the result format are inherited unchanged.
'''

import time

from kvarq_tpu import analyse
from kvarq_tpu.engine.tensor_scan import fold_into_coverage
from kvarq_tpu_torch import engine


class Analyser(analyse.Analyser):

    def scan(self, fastq, testsuites, do_reverse=True, keep_hits=False):
        ''' scan ``fastq`` against every template's plus (and minus)
            sequence and fill ``.coverages`` from the port's device base
            counts.  ``self.config`` is the port engine's configuration,
            which the result json records. '''
        if keep_hits:
            raise NotImplementedError(
                'the hit-list scan (keep_hits=True, kvarq scan -H/-x) is not '
                'yet ported to kvarq_tpu_torch')
        self._record_fastq(fastq)
        self.testsuites = testsuites
        self.coverages = self.load_coverages(testsuites,
                                             spacing=self.spacing)
        self.config = engine.get_config()

        seqs = [c.plus_seq.bases for c in self.coverages.values()]
        if do_reverse:
            seqs += [c.minus_seq.bases for c in self.coverages.values()]

        started = time.time()
        ret = engine.countseqs(self.fastq.filenames(), seqs)
        self.stats = ret['stats']
        self.hits = self.hitseqs = None
        n = len(self.coverages)
        counts = ret['basecounts']
        for i, coverage in enumerate(self.coverages.values()):
            fold_into_coverage(coverage, counts[i],
                               counts[n + i] if do_reverse else None)
        self.scantime = time.time() - started
