'''
Plain reference of the MTBC testsuite group (``MTBC/phylo`` 0.7,
``MTBC/resistance`` 2.0, ``MTBC/spoligo`` 0.2): the template windows a scan
looks for, and the calls each testsuite makes from their coverage.

The tables are a frozen copy of ``testsuites/MTBC/*.py``; the template
windows are cut again here from the ancestral genome. Nothing of the
scanning program is imported: the calls follow the published KvarQ
semantics (Steiner et al. 2014, BMC Genomics 15:881), including the
reporting quirks the KvarQ testsuites carry (noted where they occur).
'''

import os

GROUP = 'MTBC'
VERSIONS = {'MTBC/phylo': '0.7', 'MTBC/resistance': '2.0',
            'MTBC/spoligo': '0.2'}
GENOME = os.path.join('testsuites', 'MTBC', 'MTB_ancestor_reference.bases')
GENOME_NAME = 'MTB ancestor'

PAIRS = {'A': 'T', 'T': 'A', 'G': 'C', 'C': 'G', 'N': 'N'}
CODONS = {
    'TTT': 'F', 'TTC': 'F', 'TTA': 'L', 'TTG': 'L', 'CTT': 'L', 'CTC': 'L',
    'CTA': 'L', 'CTG': 'L', 'ATT': 'I', 'ATC': 'I', 'ATA': 'I', 'ATG': 'M',
    'GTT': 'V', 'GTC': 'V', 'GTA': 'V', 'GTG': 'V', 'TCT': 'S', 'TCC': 'S',
    'TCA': 'S', 'TCG': 'S', 'CCT': 'P', 'CCC': 'P', 'CCA': 'P', 'CCG': 'P',
    'ACT': 'T', 'ACC': 'T', 'ACA': 'T', 'ACG': 'T', 'GCT': 'A', 'GCC': 'A',
    'GCA': 'A', 'GCG': 'A', 'TGT': 'C', 'TGC': 'C', 'TGA': '$', 'TGG': 'W',
    'CGT': 'R', 'CGC': 'R', 'CGA': 'R', 'CGG': 'R', 'AGT': 'S', 'AGC': 'S',
    'AGA': 'R', 'AGG': 'R', 'GGT': 'G', 'GGC': 'G', 'GGA': 'G', 'GGG': 'G',
    'TAT': 'Y', 'TAC': 'Y', 'TAA': '$', 'TAG': '$', 'CAT': 'H', 'CAC': 'H',
    'CAA': 'Q', 'CAG': 'Q', 'AAT': 'N', 'AAC': 'N', 'AAA': 'K', 'AAG': 'K',
    'GAT': 'D', 'GAC': 'D', 'GAA': 'E', 'GAG': 'E',
}

# --- the tables of testsuites/MTBC -----------------------------------------

# (position, mutant base, lineage) -- MTBC/phylo, three markers a lineage;
# 'beijing sublineage' is the child of 'lineage 2'
PHYLO = [
    (3920109, 'T', 'lineage 1'), (3597682, 'T', 'lineage 1'),
    (1590555, 'T', 'lineage 1'), (1834177, 'C', 'lineage 2'),
    (3304966, 'A', 'lineage 2'), (2711722, 'G', 'lineage 2'),
    (301341, 'A', 'lineage 3'), (4266647, 'G', 'lineage 3'),
    (157129, 'T', 'lineage 3'), (3326554, 'A', 'lineage 4'),
    (2154724, 'C', 'lineage 4'), (648856, 'T', 'lineage 4'),
    (1377185, 'G', 'lineage 5'), (801959, 'T', 'lineage 5'),
    (2859147, 'T', 'lineage 5'), (2427828, 'C', 'lineage 6'),
    (378404, 'A', 'lineage 6'), (4269522, 'A', 'lineage 6'),
    (14806, 'C', 'lineage 7'), (1663221, 'G', 'lineage 7'),
    (497126, 'A', 'lineage 7'), (3480645, 'G', 'animal lineage'),
    (1427476, 'T', 'animal lineage'), (3624593, 'T', 'animal lineage'),
    (2112832, 'C', 'beijing sublineage'), (3587446, 'A', 'beijing sublineage'),
    (1849051, 'T', 'beijing sublineage'),
]
ROOTS = ['lineage 1', 'lineage 2', 'lineage 3', 'lineage 4', 'lineage 5',
         'lineage 6', 'lineage 7', 'animal lineage']
CHILDREN = {'lineage 2': ['beijing sublineage']}

# gene: (identifier, start, stop, promoter_end, plus_strand)
GENES = {
    'inhA': ('inhA', 1674202, 1675011, 1673440, True),
    'katG': ('katG', 2153889, 2156111, 2153889, False),
    'rpoB': ('rpoB', 759807, 763325, 759807, True),
    'rpoA': ('rpoA', 3877464, 3878507, 3877464, False),
    'rpoC': ('rpoC', 763370, 767320, 763370, True),
    'gyrA': ('gyrA', 7302, 9818, 7302, True),
    'gyrB': ('gyrB', 5123, 7267, 5123, True),
    'rpsL': ('rpsL', 781560, 781934, 781560, True),
    'rrsS': ('rrsS', 1471846, 1473382, 1471846, True),
    'rrsK': ('rrsK', 1471846, 1473382, 1471846, True),
    'embB': ('embB', 4246514, 4249810, 4246514, True),
    'pncA': ('pncA', 2288681, 2289241, 2288681, False),
}
# genotype identifier -> gene
GENOTYPES = {
    'inhA': ('Isoniazid resistance', 'inhA'),
    'katG': ('Isoniazid resistance', 'katG'),
    'RRDR': ('Rifampicin resistance (RRDR)', 'rpoB'),
    'rpoA': ('Rifampicin resistance (compensatory)', 'rpoA'),
    'rpoC': ('Rifampicin resistance (compensatory)', 'rpoC'),
    'QRDR': ('Fluoroquinolones resistance (QRDR)', 'gyrA'),
    'gyrA': ('Fluoroquinolones resistance', 'gyrA'),
    'gyrB': ('Fluoroquinolones resistance', 'gyrB'),
    'rpsL': ('Streptomycin resistance', 'rpsL'),
    'rrsS': ('Streptomycin resistance', 'rrsS'),
    'rrsK': ('Kanamycin/Amikacin resistance', 'rrsK'),
    'embB': ('Ethambutol resistance', 'embB'),
    'pncA': ('Pyrazinamide resistance', 'pncA'),
}
# (position, ancestral, mutant, genotype) -- MTBC/resistance SNPs
RESISTANCE_SNPS = [
    (2155276, 'C', 'T', 'katG'), (1673432, 'T', 'A', 'inhA'),
    (1673432, 'T', 'C', 'inhA'), (1673425, 'C', 'T', 'inhA'),
    (3877949, 'T', 'C', 'rpoA'), (3877949, 'T', 'G', 'rpoA'),
    (3877960, 'A', 'G', 'rpoA'), (3877960, 'A', 'C', 'rpoA'),
    (764669, 'C', 'G', 'rpoC'), (764670, 'C', 'G', 'rpoC'),
    (764817, 'T', 'C', 'rpoC'), (764817, 'T', 'G', 'rpoC'),
    (764819, 'T', 'G', 'rpoC'), (764822, 'G', 'A', 'rpoC'),
    (764822, 'G', 'C', 'rpoC'), (764840, 'A', 'G', 'rpoC'),
    (764841, 'T', 'C', 'rpoC'), (764918, 'G', 'C', 'rpoC'),
    (765461, 'A', 'C', 'rpoC'), (765462, 'A', 'G', 'rpoC'),
    (765463, 'C', 'G', 'rpoC'), (7606, 'C', 'A', 'gyrA'),
    (7677, 'G', 'A', 'gyrA'), (7678, 'C', 'G', 'gyrA'),
    (6767, 'G', 'A', 'gyrB'), (6768, 'G', 'A', 'gyrB'),
    (781687, 'A', 'G', 'rpsL'), (781822, 'A', 'C', 'rpsL'),
    (781822, 'A', 'T', 'rpsL'), (781822, 'A', 'G', 'rpsL'),
    (1472337, 'C', 'A', 'rrsS'), (1472337, 'C', 'G', 'rrsS'),
    (1472337, 'C', 'T', 'rrsS'), (1472358, 'C', 'A', 'rrsS'),
    (1472358, 'C', 'G', 'rrsS'), (1472358, 'C', 'T', 'rrsS'),
    (1472359, 'A', 'C', 'rrsS'), (1472359, 'A', 'G', 'rrsS'),
    (1472359, 'A', 'T', 'rrsS'), (1472362, 'C', 'A', 'rrsS'),
    (1472362, 'C', 'G', 'rrsS'), (1472362, 'C', 'T', 'rrsS'),
    (1472752, 'A', 'C', 'rrsS'), (1472752, 'A', 'G', 'rrsS'),
    (1472752, 'A', 'T', 'rrsS'), (1473246, 'A', 'C', 'rrsK'),
    (1473246, 'A', 'G', 'rrsK'), (1473246, 'A', 'T', 'rrsK'),
    (1473247, 'C', 'A', 'rrsK'), (1473247, 'C', 'G', 'rrsK'),
    (1473247, 'C', 'T', 'rrsK'), (4247429, 'A', 'G', 'embB'),
    (4247431, 'G', 'A', 'embB'), (4247431, 'G', 'T', 'embB'),
    (4247431, 'G', 'C', 'embB'), (4247429, 'A', 'C', 'embB'),
    (4247730, 'G', 'C', 'embB'), (4248003, 'A', 'G', 'embB'),
]
# (start, stop, direction, poslist, genotype) -- MTBC/resistance regions
RESISTANCE_REGIONS = [
    (2155167, 2155169, '-', None, 'katG'),
    (761082, 761162, '+', None, 'RRDR'),
    (7521, 7583, '+', [7521, 7522, 7523, 7569, 7570, 7571, 7572, 7573,
                       7574, 7581, 7582, 7583], 'QRDR'),
    (2288681, 2289241, '-', None, 'pncA'),
]
SPACERS = [
    'TGATCCAGAGCCGGCGACCCTCTAT', 'CAAAAGCTGTCGCCCAAGCATGAGG',
    'TAGAAGGCGATCACTGGAAGCACGG', 'CTGATGATTGGTCGGCGTATGACGT',
    'TAATCCCGCACAAGTGGTCAGAAAA', 'GAAATTGAAGCCGGAAATGACGACG',
    'GCAGCCCCGAGTACTCGCTCTCCTC', 'CGGCGAGGCTGGGGGCGGTTTCACG',
    'GCTGTCAGCACATGGGATTCCGAGT', 'GGAAGTCAACTAGAGCGGGTGTCGA',
    'CCAGGTTGCCGCCGCCGTTGCTCAC', 'ATCTCCCCGGGCGGGCAGCAGATAT',
    'GGGAGAGGGAATGGCAATGATGGTC', 'CCGAGCCGACCATCCGCATCACACC',
    'CGAAATTCACTGCGCGTTATTCAAG', 'GATTTACGACGCTGACGGGAACTCG',
    'CGGAGTCATCCGCGCGGGCCGGCGC', 'CATCTGCAGCTCGCCCGGGTCCATG',
    'ACCAGGATCAGCGCCAAGCCAGTTA', 'TGATCTTCTCTCCTGGCGAGGTCAA',
    'TCGACGATTGGGACATCGACATCGA', 'TTGTCTCAATCGTGCCGTCTGCGGT',
    'CGAGCTGGACCGCATCAGCGATGCT', 'CGAGCACGTCTCACCCAGCAGGCGG',
    'TGACAGGGTGCGGTGGTCGCTGATC', 'GCGCCGGATGATGGTGGTGCTGAAG',
    'ATCCGCGGGAAGAGATCACGAATCC', 'GTTGTGATCGCTAAACGCCGGGGCA',
    'TGGTCGTGTCGTGGAGCCTGTATTT', 'GGCTGGAAAAGGGCGCGGGGCAACC',
    'ACTTGATCGACGCGAACCTGTCTGA', 'TGAACACGCCGATACCTATTTGGTC',
    'TCAAGTGCGGCACCGCCGTCATGTC', 'TTCGACGGTGTGGGCGAGGTGACTT',
    'GTTGGAAGCGTTTCGAGCGTACGGA', 'GCTGCGGATGTGGTGCTGGATTTCG',
    'AAGGGGGACTGTGGACGAGTTCGCG', 'GCGCACAACGCATCCGCCATCCACG',
    'CCACGCCGATTTACTGGCCATCGTC', 'GGACCTGTATGAGGCACAGATGGCG',
    'TACCTGATAGAAGCCGGAAAGCTCC', 'GTCGCGCTCGTCCATGTCCCACCAT',
    'CTCCCGCACCCGGTGCGATTCTGCG',
]


def revcomp(bases):
    return ''.join(PAIRS[b] for b in reversed(bases))


def translate(bases):
    return ''.join(CODONS[bases[i:i + 3]]
                   for i in range(0, len(bases) // 3 * 3, 3))


class Genome:
    ''' the ancestral genome, 1-based like the testsuites' positions '''

    def __init__(self, root):
        with open(os.path.join(root, GENOME)) as fd:
            self.bases = fd.read()

    def read(self, pos, length):
        return self.bases[pos - 1:pos - 1 + length]


class Window:
    ''' one template window: ``plus`` is the scanned plus-strand sequence
        (flanks included), ``start``..``stop`` the region of interest '''

    def __init__(self, name, plus, left, right):
        self.name = name
        self.plus = plus
        self.start = left
        self.stop = len(plus) - right


class Test:
    ''' one test of a testsuite: its window name and what it calls '''

    def __init__(self, kind, window, genotype, **what):
        self.kind = kind          # 'snp', 'region' or 'spacer'
        self.window = window
        self.genotype = genotype
        self.__dict__.update(what)


class Group:
    ''' the MTBC tests, their distinct windows (in first-use order) and
        the genes they annotate '''

    def __init__(self, root, spacing):
        self.genome = g = Genome(root)
        self.spacing = spacing
        self.versions = VERSIONS
        self.windows = {}
        self.suites = {'MTBC/phylo': [], 'MTBC/resistance': [],
                       'MTBC/spoligo': []}
        for pos, base, lineage in PHYLO:
            self.suites['MTBC/phylo'].append(
                self._snp(pos, base, lineage))
        for pos, orig, base, genotype in RESISTANCE_SNPS:
            assert g.read(pos, 1) == orig
            self.suites['MTBC/resistance'].append(
                self._snp(pos, base, genotype))
        for start, stop, direction, poslist, genotype in RESISTANCE_REGIONS:
            name = '%s[%d:%d](%s)' % (GENOME_NAME, start, stop, direction)
            plus = g.read(start - spacing, stop - start + 1 + 2 * spacing)
            self._add(name, plus, spacing, spacing)
            self.suites['MTBC/resistance'].append(Test(
                'region', name, genotype, start=start, stop=stop,
                direction=direction, poslist=poslist))
        for i, bases in enumerate(SPACERS):
            self._add(bases, bases, 0, 0)
            self.suites['MTBC/spoligo'].append(
                Test('spacer', bases, 'spoligo%d' % i))

    def _add(self, name, plus, left, right):
        if name not in self.windows:
            self.windows[name] = Window(name, plus, left, right)

    def _snp(self, pos, base, genotype):
        s = self.spacing
        old = self.genome.read(pos, 1)
        assert old != base
        name = 'SNP%d%s%s' % (pos, old, base)
        plus = self.genome.read(pos - s, 2 * s + 1)
        self._add(name, plus[:s] + base + plus[s + 1:], s, s)
        return Test('snp', name, genotype, pos=pos, old=old, base=base)

    def sequences(self):
        ''' the scanned sequences: every window's plus strand, then every
            window's minus strand '''
        plus = [w.plus for w in self.windows.values()]
        return plus + [revcomp(s) for s in plus]

    def marker_sites(self):
        ''' [(pos, base), ...] groups that a strain can carry: each lineage's
            markers (the Beijing sublineage with lineage 2's), then each
            resistance SNP on its own '''
        groups = []
        for root in ROOTS:
            names = [root] + CHILDREN.get(root, [])
            groups.append([(pos, base) for pos, base, lin in PHYLO
                           if lin in names])
        return groups, [(pos, base) for pos, _, base, _ in RESISTANCE_SNPS]

    def region_spans(self):
        ''' [(start, stop), ...] 1-based regions of interest of every
            genome window, flanks left out '''
        spans = [(pos, pos) for pos, _, _ in PHYLO]
        spans += [(pos, pos) for pos, _, _, _ in RESISTANCE_SNPS]
        spans += [(a, b) for a, b, _, _, _ in RESISTANCE_REGIONS]
        return spans

    # --- the calls ----------------------------------------------------------

    def analyses(self, cov):
        ''' ``{testsuite: result}`` from ``cov``, a ``{window name:
            Coverage}`` '''
        return {'MTBC/phylo': self._phylo(cov),
                'MTBC/resistance': self._resistance(cov),
                'MTBC/spoligo': self._spoligo(cov)}

    def _phylo(self, cov):
        tests = self.suites['MTBC/phylo']

        def score(genotypes):
            ret = {}
            for t in tests:
                if t.genotype in genotypes:
                    ret.setdefault(t.genotype, []).append(
                        snp_validates(cov[t.window]))
            return ret

        mls = []
        for ml, xs in score(ROOTS).items():
            if sum(xs) > 1:
                mls.append(ml)
                sls = [sl for sl, ys in score(CHILDREN.get(ml, [])).items()
                       if sum(ys) > 1]
                if sls:
                    mls[-1] += '/' + '-'.join(sls)
        depths = sorted(cov[t.window].mean(False) for t in tests)
        remark = ''
        if depths[len(depths) // 2] < 10:
            remark += ' -- low coverage (median below 10x)'
        if sum(cov[t.window].mixed() for t in tests):
            remark += ' -- mixed coverage'
        return ' // '.join(mls) + remark if mls else '?' + remark

    def _spoligo(self, cov):
        tests = self.suites['MTBC/spoligo']
        spnrs = [i for i, t in enumerate(tests)
                 if cov[t.window].mean(False) >= 2]
        # the KvarQ testsuite's low-coverage check reads the last spacer
        # only (a loop-variable leak kept by its rewrite)
        low = not spnrs or cov[tests[-1].window].mean() < 10
        value, last = 0, '0'
        for n in spnrs:
            if n == 42:
                last = '1'
            else:
                value += 2 ** (41 - n)
        octal = oct(value)[2:].rjust(14, '0') + last
        binary = ''.join([bin(int(x))[2:].rjust(3, '0') for x in octal[:14]]
                         + [bin(int(x))[2:] for x in octal[14:]])
        return (octal + ' ' + binary
                + (' -- low coverage (mean below 10x)' if low else ''))

    def _mut2str(self, gene, pos, newbase):
        ident, start, stop, promoter_end, plus = GENES[gene]
        if pos < promoter_end:
            return '%s promoter mutation %d' % (ident, pos - promoter_end)
        if pos < start or pos > stop:
            return '?'
        offset = pos - start
        codon_start = start + (offset // 3) * 3
        codon = self.genome.read(codon_start, 3)
        old = self.genome.read(pos, 1)
        if plus:
            nr, at = offset // 3 + 1, pos - codon_start
        else:
            # the codon is read on the plus strand's frame and reversed
            nr, at = (stop - pos) // 3 + 1, 2 - (pos - codon_start)
            codon, old, newbase = revcomp(codon), PAIRS[old], PAIRS[newbase]
        after = codon[:at] + newbase + codon[at + 1:]
        return '%s.%s%d%s' % (ident, translate(codon), nr, translate(after))

    def _resistance(self, cov):
        ret = []
        mixed = False
        minf = 1.0
        for t in self.suites['MTBC/resistance']:
            c = cov[t.window]
            genotype, gene = GENOTYPES[t.genotype]
            if t.kind == 'snp':
                minf = c.minf()
                if minf < 0.9:
                    mixed = True
                if snp_validates(c):
                    ret.append('%s::%s=%s' % (genotype, t.window,
                                              self._mut2str(gene, t.pos,
                                                            t.base)))
                    if minf < 0.9:
                        ret[-1] += ' (%d%%)' % int(100 * minf)
                continue
            if not mixed and c.minf() < 0.9:
                mixed = True
            region = self.genome.read(t.start, t.stop - t.start + 1)
            found = region_mutations(c, len(region))
            output = []
            for pos, newbase in found:
                output.append('%d%s%s=%s' % (
                    pos + t.start, region[pos], newbase,
                    self._mut2str(gene, pos + t.start, newbase)))
                # the KvarQ testsuite reads the fraction at the region
                # position counted from the left flank's first base, and
                # annotates with the last SNP's minf
                if c.dominant_fraction(pos) < 0.9:
                    output[-1] += ' (%d%%)' % int(100 * minf)
            mutated = list(region)
            for pos, newbase in found:
                mutated[pos] = newbase
            mutated = ''.join(mutated)
            if t.direction == '-':
                region, mutated = revcomp(region), revcomp(mutated)
            if translate(region) == translate(mutated):
                continue
            if t.poslist and not [p for p, _ in found
                                  if p + t.start in t.poslist]:
                output.append('[NONE OF MUTATIONS DOCUMENTED IN REFERENCE]')
            ret.append(genotype + ' [' + ' '.join(output) + ']')
        rrdr = [t for t in self.suites['MTBC/resistance']
                if t.genotype == 'RRDR']
        if cov[rrdr[0].window].mean(False) < 10:
            ret.append('remark: low coverage (RRDR below 10x)')
        if mixed:
            ret.append('remark: mixed coverage')
        return ret


def snp_validates(c):
    ''' a SNP is called where its position is covered twice or more and
        fewer than half (floor) of the covering reads differ from the
        mutant base '''
    depth = c.coverage[c.start]
    return depth >= 2 and c.alternates(c.start) < depth // 2


def region_mutations(c, length):
    ''' [(position in the region, base), ...]: at each region position, in
        the order the coverage met its first alternate, the most common
        alternate base (ties: the alphabetically first) where its count
        passes max(1, mean - 1.5 std) '''
    threshold = max(1, c.mean() - 1.5 * c.std())
    found = []
    for cpos in c.mutation_order:
        if not c.start <= cpos < c.start + length:
            continue
        counts = c.mutations[cpos]
        base = max(sorted(counts), key=lambda b: counts[b])
        if counts[base] > threshold:
            found.append((cpos - c.start, base))
    return found
