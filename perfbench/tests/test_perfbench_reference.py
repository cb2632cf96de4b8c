'''
The plain reference on hand-made reads with a known result, against
the program's numpy scan on a generated sample, its coverage fold against
the per-hit loop it replaced, and its two matchers on an amplicon sample.
'''

import json
import os

import numpy as np
import pytest

from perfbench.lib import check, generator, refengine, refexhaustive, spec
from perfbench.reference import MTBC
from test_perfbench_refexhaustive import on_target

ROOT = spec.ROOT
RNG = np.random.default_rng(7)
TEMPLATE = ''.join(RNG.choice(list('ACGT'), 30))
COMP = {'A': 'T', 'C': 'G', 'G': 'C', 'T': 'A'}
GROUP = MTBC.Group(ROOT, 25)
# the test panel: the MTBC windows of SNPs and regions (25 bases a side)
# widened by 150 bases on both sides, merged where they meet
TEST_PANEL = generator.panel_around(GROUP.region_spans(), 25 + 150)


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
    assert rec.reads(np.array([1, 0]), np.array([0, 5]),
                     np.array([30, 3])) == [reads[1][0][:30], reads[0][0][5:8]]


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


# --- the coverage fold against the loop it replaced ------------------------

_COMPL = {'A': 'T', 'C': 'G', 'G': 'C', 'T': 'A', 'N': 'N'}


def coverages_loop(rec, tpl, hits, windows, hit_order):
    ''' ``refengine.coverages`` as a loop over every hit and every base
        of it: the oracle of the numpy fold '''
    names = list(windows)
    nwin = len(names)
    cov = {n: refengine.Coverage(w.plus, w.start, w.stop)
           for n, w in windows.items()}
    depth = [np.zeros(len(w.plus), np.int64) for w in windows.values()]
    alt = []
    for h, (r, t, d, length) in enumerate(hits.tolist()):
        seq = tpl.seqs[t]
        s = max(0, -d)
        p = int(rec.pos[r]) + s
        read = rec.arr[p:p + length].tobytes().decode('latin-1')
        j0 = max(0, d)
        w = t % nwin
        plus = t < nwin
        S = len(seq)
        if plus:
            depth[w][j0:j0 + length] += 1
        else:
            depth[w][S - j0 - length:S - j0] += 1
        for i, (x, y) in enumerate(zip(read, seq[j0:j0 + length])):
            if x != y:
                j = j0 + i
                alt.append((h, i, w, j if plus else S - 1 - j,
                            x if plus else _COMPL.get(x, x)))
    for w, n in enumerate(names):
        cov[n].coverage = [int(x) for x in depth[w]]
    if not hit_order:
        alt.sort(key=lambda a: (a[2], a[3]))
    for _, _, w, j, base in alt:
        c = cov[names[w]]
        if j not in c.mutations:
            c.mutations[j] = {}
            c.mutation_order.append(j)
        c.mutations[j][base] = c.mutations[j].get(base, 0) + 1
    return cov


def panel_config(pairs):
    ''' the test panel sampled as plain 2 x 150-bp pairs, all on target '''
    config = spec.config('mtbc_pe150_gz')
    config['reads'].update(compression='none', count=pairs,
                           panel=TEST_PANEL)
    return config


@pytest.fixture(scope='module')
def samples(tmp_path_factory):
    ''' the reference's matches of a whole-genome sample joined by reads
        cut from the templates in every mode (with N and trimmed tails),
        and of a test-panel sample '''
    tmp = tmp_path_factory.mktemp('fold')
    genome = generator.genome_codes(os.path.join(ROOT, MTBC.GENOME))
    config = spec.config('mtbc_se101')
    config['reads']['count'] = 20000
    paths, _ = generator.make_sample(genome, GROUP, config, 2 ** 32 + 9, 0,
                                     str(tmp), threads=2)
    wgs = refengine.read_stream(paths) + on_target(
        1500, np.random.default_rng(11))
    paths, _ = generator.make_sample(genome, GROUP, panel_config(3000),
                                     2 ** 32 + 9, 1, str(tmp), threads=2)
    panel = refengine.read_stream(paths)
    tpl = refengine.Templates(GROUP.sequences(), 2, 25, 25)
    out = {}
    for name, buf in (('wgs', wgs), ('panel', panel)):
        rec = refengine.Records(buf, 33 + 13, 25)
        out[name] = rec, tpl, refengine.emit(
            rec, tpl, refengine.match(rec, tpl, threads=2))
    return out


def _state(cov):
    ''' a window's whole state: bases in the order each position met them '''
    return (cov.coverage, [(j, list(m.items()))
                           for j, m in cov.mutations.items()],
            cov.mutation_order, cov.serialize())


@pytest.mark.parametrize('hit_order', [False, True], ids=['by-position',
                                                          'hit-order'])
@pytest.mark.parametrize('sample', ['wgs', 'panel'])
def test_the_fold_equals_the_loop(samples, sample, hit_order):
    rec, tpl, hits = samples[sample]
    assert len(hits) > 1000
    want = coverages_loop(rec, tpl, hits, GROUP.windows, hit_order)
    assert sum(len(c.mutations) for c in want.values()) > 100
    for chunk in (1 << 15, 97):
        got = refengine.coverages(rec, tpl, hits, GROUP.windows, hit_order,
                                  chunk=chunk)
        assert list(got) == list(want)
        for name in want:
            assert _state(got[name]) == _state(want[name]), name


def test_the_fold_of_no_hit(samples):
    rec, tpl, hits = samples['wgs']
    got = refengine.coverages(rec, tpl, hits[:0], GROUP.windows, True)
    want = coverages_loop(rec, tpl, hits[:0], GROUP.windows, True)
    assert [_state(c) for c in got.values()] == \
        [_state(c) for c in want.values()]


def test_the_fold_at_the_end_of_the_stream(tmp_path):
    ''' the last read's hit is shorter than the longest hit and ends the
        stream: its row reaches past the stream's end, masked '''
    t = noise(80)
    reads = [(flip(t, [7]), 'I' * 80),
             (rc(flip(t[30:56], [3])), 'I' * 26)]
    rec, tpl, trip, hits = scan(tmp_path, reads, [t, rc(t)])
    assert len(hits) == 2 and hits[-1, 0] == 1

    class W:
        def __init__(self, plus):
            self.plus, self.start, self.stop = plus, 0, len(plus)

    for hit_order in (False, True):
        got = refengine.coverages(rec, tpl, hits, {'t': W(t)}, hit_order)
        want = coverages_loop(rec, tpl, hits, {'t': W(t)}, hit_order)
        assert _state(got['t']) == _state(want['t'])
    assert got['t'].mutations == {7: {flip(t, [7])[7]: 1},
                                  33: {flip(t[30:56], [3])[3]: 1}}


def test_both_matchers_give_one_result_on_a_panel_sample(tmp_path):
    ''' ``check.Expected`` on the CPU (the seeded matcher at two
        mismatches) and with the brute-force one a card takes '''
    genome = generator.genome_codes(os.path.join(ROOT, MTBC.GENOME))
    config = panel_config(800)
    paths, _ = generator.make_sample(genome, GROUP, config, 2 ** 35 + 1, 0,
                                     str(tmp_path), threads=2)
    seeded = check.Expected(paths, config, GROUP)
    brute = check.Expected(paths, config, GROUP)
    brute.trip = refexhaustive.match(brute.rec, brute.tpl, chunk=256)
    np.testing.assert_array_equal(brute.trip, seeded.trip)
    for hits in (False, True):
        want, got = seeded.result(hits), brute.result(hits)
        assert got == want
        assert check.compare(got, want) == dict.fromkeys(check.FIELDS, 0)
    assert len(want['hits']) > 1000
