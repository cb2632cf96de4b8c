'''
Genetic domain model: genomes, genes, sequences, templates, SNPs, tests and
the testsuite plugin interface.

Semantics follow reference kvarq/genes.py exactly (file:line citations inline)
so that testsuites written for the reference produce identical results; the
implementation is new (Python 3, numpy-friendly).
'''

import os.path
import sys

from kvarq_tpu_torch.log import lo, format_traceback
from kvarq_tpu_torch.versions import StrictVersion

# Testsuite API compatibility gate (reference genes.py:19). Major number must
# match the testsuite's GENES_COMPATIBILITY, minor must be >= (genes.py:670-675).
COMPATIBILITY = '0.2'


class Genome:

    '''
    a reference genome from which base sequences can be read; supports flat
    ``.bases`` files (seek-on-read, never fully loaded) and FASTA (first
    sequence read into memory) -- reference genes.py:22-106
    '''

    def __init__(self, path, identifier=None, description=None):
        self.path = path
        self.f = open(path, 'r')

        self.fasta = self.f.read(1) == '>'
        if self.fasta:
            identifier, description = self._load_fasta(identifier,
                                                       description)
        else:
            self.f.seek(0, 2)
            self.size = self.f.tell()

        self.identifier = identifier
        self.description = description

    def _load_fasta(self, identifier, description):
        ''' read the first FASTA sequence into memory; identifier and
            description default to the defline's fields '''
        self.f.seek(0)
        defline = self.f.readline()
        space = defline.find(' ')
        if identifier is None:
            identifier = defline[1:] if space == -1 else defline[1:space]
        if description is None and -1 < space < len(defline):
            description = defline[space + 1:]

        self.bases = ''.join(line.rstrip('\n\r') for line in self.f)
        if '>' in self.bases:
            lo.info('%s contains several genomes; only first read'
                    % self.path)
            self.bases = self.bases[:self.bases.index('>')]
        self.size = len(self.bases)
        self.f.close()
        lo.debug('read %d bytes FASTA sequence "%s" into memory'
                 % (self.size, identifier))
        return identifier, description

    def read(self, pos, length):
        ''' read ``length`` bases starting at 1-indexed position ``pos``
            (reference genes.py:80-89) '''
        if self.fasta:
            return self.bases[pos - 1:pos - 1 + length]
        self.f.seek(pos - 1)
        return self.f.read(length)

    def seq(self, start, stop, left=0, right=0, **kwargs):
        ''' :returns: :py:class:`Sequence` spanning ``start..stop`` (1-indexed,
            inclusive) with flanks of ``left``/``right`` bases '''
        bases = self.read(start - left, stop - start + 1 + left + right)
        return Sequence(bases, left, right, pos=start - left, **kwargs)

    def __str__(self):
        return self.identifier


class Gene:

    ''' a gene within a :py:class:`Genome`; renders amino-acid/base change
        strings for mutations (reference genes.py:109-190) '''

    def __init__(self, genome, identifier, start, stop, promoter_end=None,
                 plus_strand=True, coding=True):
        self.genome = genome
        self.identifier = identifier
        self.plus_strand = plus_strand
        self.coding = coding
        assert start <= stop, 'start position must be smaller than stop position'
        self.start = start
        self.stop = stop
        if promoter_end is None:
            promoter_end = start
        self.promoter_end = promoter_end

    def _codon_context(self, pos, newbase):
        ''' resolve a + strand mutation at ``pos`` into strand-local
            coordinates: (base_nr, codon_nr, codon Sequence, offset of the
            mutation within the codon, old base, new base) -- all relative
            to the gene's own strand '''
        offset = pos - self.start
        codon_start = self.start + (offset // 3) * 3
        codon = self.genome.seq(codon_start, codon_start + 2)
        oldbase = self.genome.read(pos, 1)

        if self.plus_strand:
            return (offset + 1, offset // 3 + 1, codon,
                    pos - codon_start, oldbase, newbase)
        # minus strand: mirror position and codon, complement the bases
        return (self.stop - pos + 1, (self.stop - pos) // 3 + 1,
                codon.reverse(), 2 - (pos - codon_start),
                codon.pairs[oldbase], codon.pairs[newbase])

    def mut2str(self, pos, newbase):
        ''' render a mutation at absolute genome position ``pos`` (newbase
            on the + strand) as ``gene.XnY`` aa change, promoter mutation,
            ``?`` (outside gene) or base change for non-coding genes
            (reference genes.py:141-181) '''
        if pos < self.promoter_end:
            return '%s promoter mutation %d' % (
                self.identifier, pos - self.promoter_end)
        if pos < self.start or pos > self.stop:
            return '?'

        base_nr, codon_nr, codon, codon_mut, oldbase, newbase = \
            self._codon_context(pos, newbase)

        if self.coding:
            before = codon.transcribe()
            after = codon.transcribe(mutations=((codon_mut, newbase),))
            return '%s.%s%d%s' % (self.identifier, before, codon_nr, after)
        return '%s.%d%s%s' % (self.identifier, base_nr, oldbase, newbase)

    def __str__(self):
        if self.plus_strand:
            return 'gene %s %d..%d' % (self.identifier, self.start, self.stop)
        return 'gene %s complement(%d..%d)' % (
            self.identifier, self.start, self.stop)


class Sequence:

    ''' a base sequence with left/right margins; indexing starts at the first
        base of the left margin (reference genes.py:193-311) '''

    # complement map -- 'N' maps to itself (genes.py:204)
    pairs = {'A': 'T', 'T': 'A', 'G': 'C', 'C': 'G', 'N': 'N'}

    # DNA codon table; '$' marks stop codons (genes.py:208-217)
    code = {
        'TTT': 'F', 'TTC': 'F', 'TTA': 'L', 'TTG': 'L',
        'CTT': 'L', 'CTC': 'L', 'CTA': 'L', 'CTG': 'L',
        'ATT': 'I', 'ATC': 'I', 'ATA': 'I', 'ATG': 'M',
        'GTT': 'V', 'GTC': 'V', 'GTA': 'V', 'GTG': 'V',
        'TCT': 'S', 'TCC': 'S', 'TCA': 'S', 'TCG': 'S',
        'CCT': 'P', 'CCC': 'P', 'CCA': 'P', 'CCG': 'P',
        'ACT': 'T', 'ACC': 'T', 'ACA': 'T', 'ACG': 'T',
        'GCT': 'A', 'GCC': 'A', 'GCA': 'A', 'GCG': 'A',
        'TGT': 'C', 'TGC': 'C', 'TGA': '$', 'TGG': 'W',
        'CGT': 'R', 'CGC': 'R', 'CGA': 'R', 'CGG': 'R',
        'AGT': 'S', 'AGC': 'S', 'AGA': 'R', 'AGG': 'R',
        'GGT': 'G', 'GGC': 'G', 'GGA': 'G', 'GGG': 'G',
        'TAT': 'Y', 'TAC': 'Y', 'TAA': '$', 'TAG': '$',
        'CAT': 'H', 'CAC': 'H', 'CAA': 'Q', 'CAG': 'Q',
        'AAT': 'N', 'AAC': 'N', 'AAA': 'K', 'AAG': 'K',
        'GAT': 'D', 'GAC': 'D', 'GAA': 'E', 'GAG': 'E',
    }

    def __init__(self, bases, left=0, right=0, pos=None, plus_strand=True):
        self.bases = bases
        self.left = left
        self.right = right
        self.pos = pos
        self.plus_strand = plus_strand

    def __len__(self):
        ''' length *including* margins '''
        return len(self.bases)

    def __getitem__(self, idx):
        return self.bases[idx]

    def __setitem__(self, idx, value):
        if idx < 0 or idx > len(self.bases) - 1:
            raise IndexError
        self.bases = self.bases[:idx] + value + self.bases[idx + 1:]

    def reverse(self):
        ''' :returns: the reverse-complement sequence '''
        return Sequence(
            ''.join(self.pairs[b] for b in self.bases)[::-1],
            pos=self.pos, plus_strand=not self.plus_strand,
            left=self.left, right=self.right)

    def plus_idx(self, idx):
        ''' index that corresponds to ``idx`` on the + strand '''
        if self.plus_strand:
            return idx
        return len(self.bases) - idx - 1

    def plus_base(self, base):
        ''' base that corresponds to ``base`` on the + strand '''
        if self.plus_strand:
            return base
        return self.pairs[base]

    def _codon_at(self, pos0, mutations):
        ''' the three bases starting at ``pos0`` with any ``mutations``
            [(pos, base), ...] falling inside substituted '''
        codon = list(self[pos0:pos0 + 3])
        for mpos, newbase in mutations:
            if pos0 <= mpos < pos0 + 3:
                codon[mpos - pos0] = newbase
        return ''.join(codon)

    def get_aa(self, pos, mutations=()):
        ''' amino acid of the codon containing base position ``pos`` after
            applying ``mutations`` [(pos, base), ...] '''
        return self.code[self._codon_at(pos - pos % 3, mutations)]

    def transcribe(self, mutations=()):
        ''' one-letter amino acid string after applying ``mutations`` '''
        return ''.join(self.code[self._codon_at(pos0, mutations)]
                       for pos0 in range(0, len(self) // 3 * 3, 3))

    def apply_mutations(self, mutations):
        bases = list(self.bases)
        for pos, newbase in mutations:
            bases[pos] = newbase
        self.bases = ''.join(bases)


class Template:

    ''' object with a **unique** identifier that produces a
        :py:class:`Sequence` (reference genes.py:314-340) '''

    def __init__(self, identifier):
        self.identifier = identifier

    def validate(self, coverage):
        ''' whether the template was "found" in the .fastq file: mean depth
            within the region of interest >= 2 (genes.py:332) '''
        return coverage.mean(include_margins=False) >= 2

    def seq(self):
        raise NotImplementedError

    def __str__(self):
        return self.identifier


class StaticTemplate(Template):

    ''' template that cannot generate flanks (e.g. spoligo spacers) '''

    def __init__(self, bases, identifier=None):
        if not identifier:
            identifier = bases
        super().__init__(identifier)
        self.bases = bases

    def seq(self):
        return Sequence(self.bases)


class DynamicTemplate(Template):

    ''' template that can generate flanks '''

    def seq(self, spacing=0):
        raise NotImplementedError


class TemplateFromGenome(DynamicTemplate):

    ''' template read from a reference genome; usually the ancestral
        sequence, expected to be found unless deleted
        (reference genes.py:371-462) '''

    def __init__(self, genome, start, stop, direction='+', aa_pos0=1,
                 poslist=None):
        identifier = '%s[%d:%d](%s)' % (str(genome), start, stop, direction)
        super().__init__(identifier)

        assert start <= stop
        assert direction in '+-'

        self.genome = genome
        self.start = start
        self.stop = stop
        self.aa_pos0 = aa_pos0
        self.direction = direction
        self.poslist = poslist

    def seq(self, spacing=0):
        return self.genome.seq(self.start, self.stop, spacing, spacing)

    def transcribe(self, mutations=None):
        ''' transcribe from the strand given by ``.direction`` '''
        seq = self.seq()
        if mutations:
            seq.apply_mutations(mutations)
        if self.direction == '-':
            seq = seq.reverse()
        return seq.transcribe()

    def mutations(self, coverage):
        ''' the most prevalent alternate base per in-region position,
            subject to the prevalence gate ``n > 1 and n > mean - 1.5*std``
            (reference genes.py:424-449; ``std`` keeps its full-array
            quirk, see Coverage.std) '''
        threshold = max(1, coverage.mean() - 1.5 * coverage.std())
        region = range(coverage.start, coverage.start + len(self.seq()))

        found = []
        for cpos, bases in coverage.mutations.items():
            if cpos not in region:
                continue
            # most prevalent alternate; ties resolved alphabetically
            # (deterministic, where the reference iterated a py2 set)
            base = max(sorted(set(bases)), key=bases.count)
            if bases.count(base) > threshold:
                found.append((cpos - coverage.start, base))
        return found

    def aa_mutations(self, mutations):
        ''' [(aa_pos, old_aa, new_aa), ...] for given [(pos, base), ...] '''
        aa1 = self.transcribe()
        aa2 = self.transcribe(mutations)

        ret = []
        for i, old_aa in enumerate(aa1):
            if aa2[i] != old_aa:
                ret.append((i + self.aa_pos0, old_aa, aa2[i]))
        return ret


class SNP(TemplateFromGenome):

    ''' single nucleotide polymorphism; the template sequence is the
        **mutant** version (reference genes.py:465-508) '''

    def __init__(self, genome, pos, base, orig=None, force=False):
        super().__init__(genome, pos, pos)

        self.base = base
        self.orig = orig
        oldbase = self.genome.read(pos, 1)
        if not force:
            if orig:
                assert oldbase == self.orig, \
                    'expected orig %s found %s' % (self.orig, oldbase)
            assert base != oldbase
        self.identifier = 'SNP%d%s%s' % (pos, oldbase, base)

    def seq(self, spacing=0):
        seq = super().seq(spacing=spacing)
        seq[spacing] = self.base
        return seq

    def validate(self, coverage):
        ''' SNP present iff depth at the SNP position >= 2 and fewer than
            half the covering reads diverge from the mutant template
            (integer division as in the Python-2 reference, genes.py:503-508) '''
        c = coverage.coverage[coverage.start]
        m = len(coverage.mutations.get(coverage.start, []))
        return c >= 2 and m < c // 2


class Reference:

    ''' a (literature) reference where genetic information is defined '''

    def __init__(self, descr):
        self.descr = descr


class Genotype:

    def __init__(self, identifier, gene=None):
        self.identifier = identifier
        self.gene = gene

    def __str__(self):
        return str(self.identifier)

    def __repr__(self):
        return '<%s : "%s">' % (self.__class__.__name__, self.identifier)


class Test:

    ''' links a :py:class:`Template` to a :py:class:`Genotype` '''

    def __init__(self, template, genotype, reference):
        assert '::' not in str(template)
        self.template = template
        self.genotype = genotype
        self.reference = reference

    def __str__(self):
        return '%s::%s' % (self.genotype, self.template)


class AnalysisException(RuntimeError):
    ''' raised if an error occurs during :py:meth:`Testsuite.analyse` '''


class Testsuite:

    ''' interprets scan results using an array of :py:class:`Test`
        (reference genes.py:560-632) '''

    def __init__(self, tests, version):
        self.tests = tests
        self.version = version

    @staticmethod
    def _describe_region_mutation(test, pos, newbase):
        ''' render one region mutation: absolute position + base change,
            with the aa annotation when the genotype names a gene '''
        genome_pos = pos + test.template.start
        text = '%d%s%s' % (genome_pos, test.template.seq()[pos], newbase)
        if test.genotype.gene:
            text += '=' + test.genotype.gene.mut2str(genome_pos, newbase)
        return text

    def _analyse(self, coverages):
        ''' generic analysis: validated SNPs by test name, region
            mutations as annotated base changes '''
        findings = []
        for test in self.tests:
            coverage = coverages[test]
            if isinstance(test.template, SNP):
                if test.template.validate(coverage):
                    findings.append(str(test))
            elif isinstance(test.template, TemplateFromGenome):
                findings.extend(
                    self._describe_region_mutation(test, pos, newbase)
                    for pos, newbase
                    in test.template.mutations(coverage))
        return findings

    def analyse(self, analyser):
        ''' :param analyser: :py:class:`kvarq_tpu_torch.analyse.Analyser` holding
            scan results
            :returns: findings (string or list of strings) '''
        coverages = {}
        for test in self.tests:
            try:
                coverages[test] = analyser[test]
            except KeyError:
                raise AnalysisException(
                    'template "%s" not found' % str(test.template))
        return self._analyse(coverages)

    def __str__(self):
        return 'generic Testsuite with %d tests' % len(self.tests)


# marks a sys.modules key that was not set
_ABSENT = object()


class TestsuiteLoadingException(Exception):
    ''' raised if an error is encountered while loading a testsuite '''


def load_testsuite(fname):
    '''
    load a modular testsuite from a ``.py`` file (reference genes.py:638-683).

    The file is executed in a fresh namespace; it must define
    ``GENES_COMPATIBILITY`` (checked against :py:data:`COMPATIBILITY`) and a
    module-level :py:class:`Testsuite` instance named after the file (up to the
    first ``-``).

    For compatibility with testsuites written for the (Python 2) reference,
    the namespace provides ``file = open``, and while the file runs the
    names ``kvarq``, ``kvarq.genes`` and ``kvarq.log`` are this package and
    its modules (restored afterwards), so one process can load the same
    plugins through kvarq_tpu and through this package.

    **beware** that the testsuite is a python file and can execute arbitrary
    code.
    '''

    name = os.path.splitext(os.path.basename(fname))[0]
    if '-' in name:
        name = name[:name.index('-')]
    namespace = dict(
        __file__=fname,
        __module__='kvarq_tpu_torch.testsuites.' + name,
        file=open,  # python-2 style testsuites use file()
    )

    # testsuites import sibling helper modules (e.g. ``from _util import
    # ancestor``); make those imports resolve to the plugin's directory and
    # to this package.  A cached sibling is evicted whatever its directory:
    # one from this directory may have been loaded under kvarq_tpu, and its
    # objects would then be kvarq_tpu's classes.
    plugin_dir = os.path.dirname(os.path.abspath(fname))
    siblings = [sib[:-3] for sib in (os.listdir(plugin_dir)
                                     if os.path.isdir(plugin_dir) else [])
                if sib.endswith('.py')]
    shadowed = {modname: sys.modules.pop(modname) for modname in siblings
                if modname in sys.modules}
    # ``from kvarq.genes import ...`` / ``from kvarq.log import ...`` in the
    # plugin bind to this package while it runs, whatever ``kvarq`` is
    # outside (kvarq_tpu's alias package, or nothing)
    import kvarq_tpu_torch
    from kvarq_tpu_torch import log
    aliases = {'kvarq': kvarq_tpu_torch, 'kvarq.genes': sys.modules[__name__],
               'kvarq.log': log}
    outside = {key: sys.modules.get(key, _ABSENT) for key in aliases}

    sys.modules.update(aliases)
    sys.path.insert(0, plugin_dir)
    try:
        with open(fname) as f:
            code = compile(f.read(), fname, 'exec')
        exec(code, namespace)
    except Exception as e:
        raise TestsuiteLoadingException(
            'exception while reading file : %s [%s]' % (
                str(e), format_traceback(sys.exc_info())))
    finally:
        # drop the siblings this plugin loaded from the global cache and
        # restore what was there before, aliases included
        sys.path.remove(plugin_dir)
        for modname in siblings:
            sys.modules.pop(modname, None)
        sys.modules.update(shadowed)
        for key, mod in outside.items():
            if mod is _ABSENT:
                sys.modules.pop(key, None)
            else:
                sys.modules[key] = mod

    if 'GENES_COMPATIBILITY' not in namespace:
        raise TestsuiteLoadingException(
            'module defines no "GENES_COMPATIBILITY"')

    compat = StrictVersion(namespace['GENES_COMPATIBILITY'])
    version = StrictVersion(COMPATIBILITY)

    if compat > version or compat.version[0] != version.version[0]:
        raise TestsuiteLoadingException(
            'incompatible : %s needed, got %s' % (compat, version))

    if name not in namespace:
        raise TestsuiteLoadingException('could not import "%s"' % name)
    if not isinstance(namespace[name], Testsuite):
        raise TestsuiteLoadingException(
            'module defines "%s" but is of type %s' %
            (name, type(namespace[name])))

    return namespace[name]
