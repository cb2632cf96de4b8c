'''
FastQ input model: PHRED-variant inference, format validation, paired-file
handling, and record-level random access (used to pull hit sequences back
out of the file after a scan).

Scanning itself never goes through this class -- the native reader
(kvarq_tpu_torch.engine.reader) re-parses the file into device batches.  This
module owns everything the *driver* needs to know about a FastQ file
before and after the scan.  Validation/inference semantics follow the
reference (kvarq/fastq.py, citations inline).
'''

import collections
import gzip
import math
import os.path

from kvarq_tpu_torch.log import lo, tictoc


class FastqFileFormatException(Exception):
    pass


#: printable PHRED alphabet chr(33)..chr(126) (reference fastq.py:41-42)
PHRED_ALPHABET = ''.join(chr(c) for c in range(33, 127))

VendorProperties = collections.namedtuple('VendorProperties',
                                          ['Qrange', 'dQ'])

#: vendor variants with plausible Q ranges and ASCII offsets (reference
#: fastq.py:44-53); declaration order is also the order of reported
#: ``Fastq.variants``
VENDOR_VARIANTS = dict((
    ('Sanger', VendorProperties(range(0, 50), 0)),
    ('Solexa', VendorProperties(range(-5, 41), 31)),
    ('Illumina 1.3+', VendorProperties(range(0, 41), 31)),
    ('Illumina 1.5+', VendorProperties(range(3, 42), 31)),
    ('Illumina 1.8+', VendorProperties(range(0, 62), 0)),
))


def find_mate(fname):
    ''' the ``_2`` companion of an ``X_1.fastq[.gz]`` file, if it exists
        on disk (reference fastq.py:90-98) '''
    stem = fname[:fname.rindex('.fastq')]
    if not stem.endswith('_1'):
        return None
    mate = stem[:-2] + '_2' + fname[fname.rindex('.fastq'):]
    return mate if os.path.exists(mate) else None


class Fastq:

    # class-level aliases kept for API compatibility
    ASCII = PHRED_ALPHABET
    VendorProperties = VendorProperties
    vendor_variants = VENDOR_VARIANTS

    def __init__(self, fname, variant=None, fd=None, paired=False,
                 quiet=False):
        '''
        open a ``.fastq``/``.fastq.gz`` file, validate a sample of its
        records and infer the PHRED encoding (setting ``.dQ``, ``.Azero``
        and ``.variants``)

        :param variant: name from :py:data:`VENDOR_VARIANTS` to skip the
            inference (only warns if incompatible with the file)
        :param fd: pre-opened binary file object to use instead
        :param paired: also register ``X_2.fastq`` when given ``X_1.fastq``
        :param quiet: no info-level summary log line
        '''
        self.fname = fname
        self.gz = fname.endswith('.fastq.gz')
        if not self.gz and not fname.endswith('.fastq'):
            raise FastqFileFormatException(
                'fastq file must have extension ".fastq" or ".fastq.gz"')
        self.fd = fd or self._open(fname)

        self.fname2 = find_mate(fname) if paired else None
        if self.fname2 and not quiet:
            lo.info('including paired file "%s"' % self.fname2)

        if not sum(self.filesizes()):
            raise FastqFileFormatException('cannot scan empty file')

        min_pos, max_pos = self.min_max_score_check_file()
        lo.debug('min_pos=%d max_pos=%d' % (min_pos, max_pos))
        self.variants, self.dQ = self._resolve_variant(
            variant, min_pos, max_pos)
        self.Azero = self.ASCII[self.dQ]

        self._estimate_dimensions()
        if not quiet:
            self._log_summary()

    # --- opening / basic properties -------------------------------------

    def _open(self, fname):
        if self.gz:
            return gzip.GzipFile(fname, 'rb')
        return open(fname, 'rb')

    def filenames(self):
        return [self.fname] + ([self.fname2] if self.fname2 else [])

    def filesizes(self):
        return [os.path.getsize(f) for f in self.filenames()]

    def _readline(self):
        ''' one line from the binary handle, decoded byte-per-char '''
        return self.fd.readline().decode('latin-1')

    def _estimate_dimensions(self):
        ''' readlength + record count guessed from the first record
            (reference fastq.py:143-152) '''
        self.fd.seek(0)
        raw = [self.fd.readline() for _ in range(4)]
        self.readlength = len(raw[1].decode('latin-1').strip('\r\n'))
        if self.gz:
            self.records_approx = None
        else:
            per_record = len(b''.join(raw))
            self.records_approx = (os.path.getsize(self.fname) // per_record
                                   * len(self.filenames()))

    def _log_summary(self):
        if self.gz:
            lo.info('gzipped fastq : readlength=? records_approx=? '
                    'dQ=%d variants=%s' % (self.dQ, str(self.variants)))
        else:
            lo.info('fastq : readlength=%d records_approx=%d dQ=%d '
                    'variants=%s' % (self.readlength, self.records_approx,
                                     self.dQ, str(self.variants)))

    # --- variant inference ----------------------------------------------

    def _resolve_variant(self, requested, min_pos, max_pos):
        '''
        match observed PHRED extremes against the vendor table; an
        explicitly requested variant always wins (with a warning when the
        observed scores don't fit it) -- reference fastq.py:111-138
        '''
        if requested and requested not in VENDOR_VARIANTS:
            raise FastqFileFormatException(
                'unknown vendor variant "%s"' % requested)

        compatible = [name for name, props in VENDOR_VARIANTS.items()
                      if min_pos - props.dQ in props.Qrange
                      and max_pos - props.dQ in props.Qrange]

        if requested:
            if requested not in compatible:
                lo.warning('specified vendor variant "%s" seems not to be '
                           'compatible with file' % requested)
            return [requested], VENDOR_VARIANTS[requested].dQ

        if not compatible:
            raise FastqFileFormatException(
                'could not find any suitable fastq vendor variant')
        dQs = set(VENDOR_VARIANTS[name].dQ for name in compatible)
        if len(dQs) > 1:
            raise FastqFileFormatException(
                'cannot determine dQ with guessed vendor variants "%s"'
                % str(compatible))
        return compatible, dQs.pop()

    # --- record sampling -------------------------------------------------

    def _sample_records(self, budget, points):
        '''
        yield ``(identifier, bases, separator, phred)`` tuples (line
        endings stripped) sampled across the file.  The shrinking-budget
        loop reproduces the reference (fastq.py:176-238, :263-293): in
        practice the whole budget is consumed sequentially from the first
        point, and the remaining seek positions only come into play when
        the file ends early.  A blank identifier line is yielded as an
        all-empty tuple *without* consuming further lines, leaving the
        file position right after it.
        '''
        self.fd.seek(0)
        if self.gz:
            lo.debug('gzipped fastq : scan %d points at start only' % budget)

        for point in range(points):
            if point and not self.gz:
                self.fd.seek(os.path.getsize(self.fname) * point // points)
                self.seekback()

            while budget > (points - 1 - point) * budget // points:
                budget -= 1
                identifier = self._readline().rstrip('\n\r')
                if not identifier:
                    yield '', '', '', ''
                else:
                    yield (identifier,) + tuple(
                        self._readline().rstrip('\n\r') for _ in range(3))

    @staticmethod
    def _validate_record(identifier, bases, separator, phred):
        ''' per-record format checks (reference fastq.py:200-236); raises
            with the reference messages '''
        if not identifier.startswith('@'):
            raise FastqFileFormatException(
                'identifier (1st line of record) must begin with "@"')
        if not set(bases) <= set('AGCTN'):
            raise FastqFileFormatException(
                'bases (2nd line of record) must contain only AGCTN')
        if not (separator.startswith('+')
                and separator[1:] in ('', identifier[1:])):
            raise FastqFileFormatException(
                'separator (3rd line of record) must be == "+" or "+(ident)"')
        if not (len(phred) == len(bases)
                or (len(phred) == len(bases) + 1 and phred[-1] == '!')):
            raise FastqFileFormatException(
                'bases must be ~ same length as phred score (2nd, 4th line)')

    def _check_only_blank_until_eof(self):
        ''' blank lines may pad the end of the file, nothing else '''
        while True:
            line = self._readline()
            if not line:
                return
            if line.rstrip('\r\n'):
                raise FastqFileFormatException(
                    'non-empty line after empty line (fpos=%d'
                    % self.fd.tell())

    def min_max_score_check_file(self, n=1000, points=10):
        '''
        validate a sample of records and return the positions (within
        :py:data:`PHRED_ALPHABET`) of the lowest/highest quality score
        observed
        '''
        lowest, highest = len(self.ASCII), -1
        hit_eof = False
        for identifier, bases, separator, phred in \
                self._sample_records(n, points):
            if not identifier:
                hit_eof = True
                break
            self._validate_record(identifier, bases, separator, phred)
            try:
                positions = [self.ASCII.index(a) for a in phred]
            except ValueError:
                raise FastqFileFormatException(
                    'phred score (4th line of record) must contain only '
                    '"%s"' % self.ASCII)
            lowest = min(lowest, *positions)
            highest = max(highest, *positions)

        if hit_eof:
            self._check_only_blank_until_eof()
        return lowest, highest

    def lengths(self, Amin, n=1000, points=10):
        ''' sample the lengths of quality-trimmed reads (for the ``show
            -Q`` histogram); reads that trim away completely are skipped '''
        out = []
        for _, _, _, phred in self._sample_records(n, points):
            _, length = self.cutoff(phred, Amin)
            if length >= 0:
                out.append(length)
        return out

    # --- quality scores ----------------------------------------------------

    def A2Q(self, A):
        ''' PHRED ASCII char -> Q value '''
        return self.ASCII.index(A) - self.dQ

    def Q2A(self, Q):
        ''' Q value -> PHRED ASCII char '''
        return self.ASCII[Q + self.dQ]

    def Q2p(self, Q):
        ''' Q value -> error probability '''
        return 10 ** (-.1 * Q)

    def p2Q(self, p):
        ''' error probability -> Q value '''
        return int(-10 * math.log(p) / math.log(10))

    def cutoff(self, scores, Amin):
        '''
        ``(position, length)`` of the first longest run of quality chars
        ``>= Amin``.

        Candidate runs are maximal runs *terminated by* a low-quality
        character: a final run extending to the end of the read is not
        considered, and a leading low-quality character registers a
        zero-length run at position 0.  These quirks come from the
        reference implementation (kvarq/fastq.py:295-308) and are pinned
        by tests; the on-device trim (which handles the final run) lives
        in the engine and matches workhorse.c:1055-1070 instead.
        '''
        best_pos, best_len = 0, -1
        run_start = 0
        for j, ch in enumerate(scores):
            if ch >= Amin:
                if run_start < 0:
                    run_start = j
            elif run_start >= 0:
                if j - run_start > best_len:
                    best_pos, best_len = run_start, j - run_start
                run_start = -1
        return best_pos, best_len

    # --- record-level random access ---------------------------------------

    def readhit(self, hit):
        ''' the overlapping bases of a :py:class:`kvarq_tpu_torch.engine.Hit`,
            read back from the file (``file_pos`` counts decompressed
            bytes, which is also what ``GzipFile.seek`` expects) '''
        offset = hit.file_pos - min(hit.seq_pos, 0)
        self.fd.seek(offset)
        return self.fd.read(hit.length).decode('latin-1')

    @tictoc('fastq.readhits')
    def readhits(self, hits):
        return [self.readhit(hit) for hit in hits]

    def lineup(self):
        ''' rewind the file position to the start of the current line (or
            of the previous line when already at a line start) '''
        pos = self.fd.tell()
        while pos > 0:
            pos -= 1
            self.fd.seek(max(0, pos - 1))
            if self.fd.read(1) == b'\n':
                break
        if pos == 0:
            self.fd.seek(0)

    def seekback(self):
        '''
        rewind to the start of the current/previous record: walk line
        starts backwards until one begins with ``+``, which anchors the
        separator line (a second ``+`` immediately above means the quality
        line itself starts with ``+`` and the true separator is that upper
        line) -- reference fastq.py:320-351
        '''
        while True:
            self.lineup()
            line = self.fd.readline()
            self.lineup()
            if line[0:1] == b'+':
                self.lineup()
                probe = self.fd.readline()
                self.lineup()
                if probe[0:1] == b'+':
                    self.lineup()
                self.lineup()
                return
            if self.fd.tell() == 0:
                return

    def readrecord(self):
        ''' the four lines of the record at the current file position '''
        return tuple(self._readline().strip() for _ in range(4))

    def readrecordat(self, hit):
        ''' full FastQ record containing ``hit``, as one ``str`` (used by
            ``scan --extract-hits``) '''
        self.fd.seek(hit.file_pos)
        self.seekback()
        self.readrecord()                  # skip the record before ours
        return '\n'.join(self.readrecord()) + '\n'
