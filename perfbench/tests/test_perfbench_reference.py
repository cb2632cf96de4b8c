'''
The plain reference on hand-made reads with a known result, and against
the program's numpy scan on a generated sample.
'''

import json
import os

import numpy as np
import pytest

from perfbench.lib import check, generator, refengine, spec
from perfbench.reference import MTBC

ROOT = spec.ROOT
RNG = np.random.default_rng(7)
TEMPLATE = ''.join(RNG.choice(list('ACGT'), 30))
COMP = {'A': 'T', 'C': 'G', 'G': 'C', 'T': 'A'}


def rc(s):
    return ''.join(COMP[b] for b in reversed(s))


def noise(n):
    return ''.join(RNG.choice(list('ACGT'), n))


def flip(s, positions):
    s = list(s)
    for p in positions:
        s[p] = {'A': 'C', 'C': 'G', 'G': 'T', 'T': 'A'}[s[p]]
    return ''.join(s)


def fastq(path, reads):
    with open(path, 'w') as fd:
        for i, (seq, qual) in enumerate(reads):
            fd.write('@r%d\n%s\n+\n%s\n' % (i, seq, qual))


def scan(tmp_path, reads, seqs, e=2, o=25, r=25):
    fastq(tmp_path / 'x.fastq', reads)
    buf = refengine.read_stream([str(tmp_path / 'x.fastq')])
    rec = refengine.Records(buf, 33 + 13, r)
    tpl = refengine.Templates(seqs, e, o, r)
    trip = refengine.match(rec, tpl, threads=2)
    return rec, tpl, trip, refengine.emit(rec, tpl, trip)


def test_trim_takes_the_first_longest_run(tmp_path):
    good, bad = 'I', '#'
    reads = [(noise(40), good * 40),
             (noise(40), good * 30 + bad * 10),
             (noise(40), good * 12 + bad + good * 20 + bad * 7),
             (noise(40), good * 15 + bad + good * 15 + bad * 9),
             (noise(40), good * 10 + bad * 30),
             (noise(40), bad * 40)]
    fastq(tmp_path / 'x.fastq', reads)
    rec = refengine.Records(refengine.read_stream([str(tmp_path / 'x.fastq')]),
                            33 + 13, 25)
    assert rec.n == 6
    # every record in the histogram, the short ones dropped
    assert rec.histogram[40] == 1 and rec.histogram[30] == 1
    assert rec.histogram[20] == 1 and rec.histogram[15] == 1
    assert rec.histogram[10] == 1 and rec.histogram[0] == 1
    assert list(rec.rl) == [40, 30]
    assert rec.read(1, 0, 30) == reads[1][0][:30]


def test_modes_errors_and_strands(tmp_path):
    t = TEMPLATE
    q = 'I' * 60
    reads = [
        (noise(15) + t + noise(15), q),              # C: template inside
        (flip(t[4:], [3, 20]) + noise(34), q[:60]),  # B: read head, 2 errs
        (flip(t[4:], [3, 10, 20]) + noise(34), q),   # B with 3 errs: none
        (noise(33) + t[:27], q),                     # A: read tail, 27 bp
        (rc(noise(15) + t + noise(15)), q),          # C on the minus strand
        (noise(60), q),                              # nothing
    ]
    rec, tpl, trip, hits = scan(tmp_path, reads, [t, rc(t)])
    got = sorted(map(tuple, hits.tolist()))
    assert got == sorted([(0, 0, -15, 30), (1, 0, 4, 26), (3, 0, -33, 27),
                          (4, 1, -15, 30)])
    mism = {(r, t_): m for r, t_, d, m in trip.tolist()}
    assert mism[(1, 0)] == 2 and mism[(0, 0)] == 0


def test_read_inside_a_long_template_counts_twice_at_its_end(tmp_path):
    # KvarQ's modes B and D both emit a read that ends at the template's
    # end: the reference keeps both
    t = noise(80)
    read = t[40:]
    rec, tpl, trip, hits = scan(tmp_path, [(read, 'I' * 40)], [t])
    assert sorted(map(tuple, hits.tolist())) == [(0, 0, 40, 40)] * 2


def test_coverage_and_alternates_on_both_strands(tmp_path):
    t = TEMPLATE
    read = flip(noise(10) + t + noise(10), [10 + 5])
    reads = [(read, 'I' * 50), (rc(read), 'I' * 50)]
    rec, tpl, trip, hits = scan(tmp_path, reads, [t, rc(t)])

    class W:
        def __init__(self, plus):
            self.plus, self.start, self.stop = plus, 0, len(plus)

    cov = refengine.coverages(rec, tpl, hits, {'t': W(t)}, False)['t']
    assert cov.coverage == [2] * 30
    alt = flip(t, [5])[5]
    assert cov.mutations == {5: {alt: 2}}
    assert cov.serialize() == '-'.join(['2'] * 30) + ' 5[%s%s]' % (alt, alt)


@pytest.mark.parametrize('errors', [2, 4])
def test_control_fails_where_the_program_passes(tmp_path, errors):
    ''' the control (one mismatch fewer allowed) differs from the reference
        on a generated sample: at the configuration's two mismatches (the
        seeded matcher), and at four (the brute-force one) '''
    group = MTBC.Group(ROOT, 25)
    config = spec.config('mtbc_se101')
    config['reads']['count'] = 60000
    config['scan']['errors'] = errors
    genome = generator.genome_codes(os.path.join(ROOT, MTBC.GENOME))
    paths, _ = generator.make_sample(genome, group, config, 12, 0,
                                     str(tmp_path))
    exp = check.Expected(paths, config, group)
    for hits in (False, True):
        want = exp.result(hits)
        assert not any(check.compare(want, want).values())
        ctl = check.compare(exp.result(hits, errors=errors - 1), want)
        assert ctl['coverages'] > 0 and ctl['stats'] > 0
        if hits:
            assert ctl['hits'] > 0


@pytest.mark.parametrize('hits', [False, True], ids=['cov', 'hits'])
def test_reference_equals_the_programs_numpy_scan(tmp_path, hits):
    ''' the program's host scan (its numpy backend, no device) gives the
        reference's result, byte for byte where it is compared '''
    from kvarq_tpu_torch import cli
    group = MTBC.Group(ROOT, 25)
    config = spec.config('mtbc_pe150_gz')
    config['reads']['count'] = 8000
    genome = generator.genome_codes(os.path.join(ROOT, MTBC.GENOME))
    paths, _ = generator.make_sample(genome, group, config, 2 ** 31 + 3, 0,
                                     str(tmp_path))
    out = str(tmp_path / 'out.json')
    traffic = spec.traffic('hits' if hits else 'cov')
    from perfbench.lib import harness
    argv = harness.cli_argv(config, traffic, paths[0], out, card=False)
    argv[argv.index('--backend') + 1] = 'numpy'
    cli.main(argv)
    with open(out) as fd:
        got = json.load(fd)
    want = check.Expected(paths, config, group).result(hits)
    assert check.compare(got, want) == dict.fromkeys(check.FIELDS, 0)
