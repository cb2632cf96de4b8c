'''
The sample generator: the same seed gives the same bytes, the read layout
and pairing are as the configuration states, gzip is several members,
reads come from the strain, and with a panel from its amplicons; the
configurations' samples are the bytes they were before the panel.
'''

import gzip
import hashlib
import os
import zlib

import numpy as np
import pytest

from perfbench.lib import generator, refengine, spec
from perfbench.reference import MTBC

ROOT = spec.ROOT


@pytest.fixture(scope='module')
def genome():
    return generator.genome_codes(os.path.join(ROOT, MTBC.GENOME))


@pytest.fixture(scope='module')
def group():
    return MTBC.Group(ROOT, 25)


def small(name, count):
    config = spec.config(name)
    config['reads']['count'] = count
    return config


def records(path):
    data = refengine.read_stream([path])
    lines = data.split(b'\n')[:-1]
    assert len(lines) % 4 == 0
    return [lines[i:i + 4] for i in range(0, len(lines), 4)]


def test_same_seed_same_bytes_other_seed_other_bytes(genome, group,
                                                     tmp_path):
    config = small('mtbc_se101', 3000)
    seed = 2 ** 31 + 77
    os.makedirs(tmp_path / 'b')
    os.makedirs(tmp_path / 'c')
    a = generator.make_sample(genome, group, config, seed, 0,
                              str(tmp_path))
    b = generator.make_sample(genome, group, config, seed, 0,
                              str(tmp_path / 'b'), threads=1)
    c = generator.make_sample(genome, group, config, seed + 1, 0,
                              str(tmp_path / 'c'))
    read = [open(x[0][0], 'rb').read() for x in (a, b, c)]
    assert read[0] == read[1]
    assert read[0] != read[2]
    assert a[1] == b[1]


def test_second_sample_differs(genome, group, tmp_path):
    config = small('mtbc_se101', 2000)
    a = generator.make_sample(genome, group, config, 5, 0, str(tmp_path))
    b = generator.make_sample(genome, group, config, 5, 1, str(tmp_path))
    assert a[0] != b[0]
    assert open(a[0][0], 'rb').read() != open(b[0][0], 'rb').read()


def test_single_end_layout(genome, group, tmp_path):
    config = small('mtbc_se101', 5000)
    paths, _ = generator.make_sample(genome, group, config, 9, 0,
                                     str(tmp_path))
    assert len(paths) == 1 and paths[0].endswith('s0.fastq')
    recs = records(paths[0])
    assert len(recs) == 5000
    assert generator.reads_per_sample(config['reads']) == 5000
    real = set(open(os.path.join(ROOT, config['model']['qualities']),
                    'rb').read()) - {10}
    for head, seq, plus, qual in recs:
        assert head.startswith(b'@') and plus == b'+'
        assert len(seq) == len(qual) == 101
        assert set(seq) <= set(b'ACGT')
        assert set(qual) <= real


def test_paired_gzip_layout(genome, group, tmp_path):
    config = small('mtbc_pe150_gz', 3000)
    paths, _ = generator.make_sample(genome, group, config, 9, 1,
                                     str(tmp_path))
    assert [os.path.basename(p) for p in paths] == ['s1_1.fastq.gz',
                                                    's1_2.fastq.gz']
    assert generator.reads_per_sample(config['reads']) == 6000
    one, two = records(paths[0]), records(paths[1])
    assert len(one) == len(two) == 3000
    for (h1, s1, _, q1), (h2, s2, _, q2) in zip(one, two):
        assert h1[:-2] == h2[:-2] and h1.endswith(b'/1') \
            and h2.endswith(b'/2')
        assert len(s1) == len(s2) == len(q1) == len(q2) == 150
    data = open(paths[0], 'rb').read()
    assert data[:2] == b'\x1f\x8b'
    assert gzip.decompress(data).count(b'\n') == 4 * 3000


def test_gzip_members_per_block(genome, group, tmp_path, monkeypatch):
    monkeypatch.setattr(generator, 'BLOCK', 1000)
    config = small('mtbc_pe150_gz', 3000)
    paths, _ = generator.make_sample(genome, group, config, 4, 0,
                                     str(tmp_path))
    data = open(paths[0], 'rb').read()
    # one member a block: three gzip headers
    assert data.count(b'\x1f\x8b\x08') >= 3
    assert len(records(paths[0])) == 3000


def test_reads_come_from_the_strain(genome, group, tmp_path):
    config = small('mtbc_pe150_gz', 400)
    config['model']['error_rate'] = 0.0
    rng = np.random.Generator(np.random.PCG64(
        np.random.SeedSequence([3, 0, 0]).spawn(2)[0]))
    strain, planted = generator.strain(genome, group, config['model'], rng)
    text = generator.BASES[strain].tobytes()
    comp = bytes.maketrans(b'ACGT', b'TGCA')
    paths, planted2 = generator.make_sample(genome, group, config, 3, 0,
                                            str(tmp_path))
    assert planted == planted2
    for path in paths:
        for _, seq, _, _ in records(path)[:100]:
            assert seq in text or seq.translate(comp)[::-1] in text
    last = dict(planted)
    for pos, base in last.items():
        assert text[pos - 1:pos] == base.encode()


def test_fragment_lengths_within_limits(genome, group, tmp_path):
    config = small('mtbc_pe150_gz', 300)
    config['model']['error_rate'] = 0.0
    config['model']['snp_rate'] = 0.0
    config['model']['window_snps'] = 0
    config['model']['resistance_snps'] = [0, 0]
    paths, planted = generator.make_sample(genome, group, config, 8, 0,
                                           str(tmp_path))
    text = generator.BASES[genome].tobytes()
    for p, b in planted:
        text = text[:p - 1] + b.encode() + text[p:]
    comp = bytes.maketrans(b'ACGT', b'TGCA')
    f = config['reads']['fragment']
    for (_, s1, _, _), (_, s2, _, _) in zip(records(paths[0])[:50],
                                            records(paths[1])[:50]):
        a = text.find(s1)
        if a >= 0:
            # plus-strand fragment: mate 2 is the reverse complement of
            # its far end
            b = text.find(s2.translate(comp)[::-1])
            frag = b + 150 - a
        else:
            b = text.find(s2)
            a = text.find(s1.translate(comp)[::-1])
            frag = a + 150 - b
        assert f['min'] <= frag <= f['max']


def real_lines(config, cycles):
    path = os.path.join(ROOT, config['model']['qualities'])
    lines = [x for x in open(path, 'rb').read().split(b'\n') if x]
    return np.array([np.frombuffer(x[:cycles], np.uint8) for x in lines])


def full_share(q, amin=33 + 13):
    return float((q >= amin).all(1).mean())


@pytest.mark.parametrize('name', ['mtbc_se101', 'mtbc_pe150_gz'])
def test_each_quality_step_is_a_real_lines_step(name):
    config = spec.config(name)
    model = generator.quality_lines(config)
    q = model.draw(4000, np.random.default_rng(7))
    real = model.lines
    c = model.cycles
    assert q.shape == (4000, config['reads']['read_length'])
    for i in range(1, q.shape[1]):
        seen = set(zip(real[:, c[i - 1]].tolist(), real[:, c[i]].tolist()))
        assert set(zip(q[:, i - 1].tolist(), q[:, i].tolist())) <= seen
    # not one whole line copied: reads switch lines
    assert len({bytes(x) for x in q}) > 0.9 * len(q)


def test_paired_qualities_trim_and_compress_as_the_real_reads():
    # cycle for cycle over the first 150 of the real 251-cycle lines
    config = spec.config('mtbc_pe150_gz')
    q = generator.quality_lines(config).draw(20000,
                                             np.random.default_rng(3))
    real = real_lines(config, 150)
    assert abs(full_share(q) - full_share(real)) < 0.12
    assert abs(q.mean() - real.mean()) < 1.5

    def ratio(x):
        data = b'\n'.join(bytes(r) for r in x)
        return len(zlib.compress(data, 4)) / len(data)
    assert 0.85 < ratio(q) / ratio(real) < 1.25


# --- a panel of amplicons ----------------------------------------------------

COMP = bytes.maketrans(b'ACGT', b'TGCA')


def revcomp(seq):
    return seq.translate(COMP)[::-1]


def test_panel_around_widens_and_merges():
    assert generator.panel_around([(500, 500), (100, 120), (300, 300),
                                   (131, 140)], 10) == [
        [90, 150], [290, 310], [490, 510]]
    # touching stretches merge too
    assert generator.panel_around([(10, 20), (41, 50)], 10) == [[0, 60]]


@pytest.fixture(scope='module')
def panel(group):
    ''' the MTBC windows of SNPs and regions widened by 150 bases a side:
        41 amplicons, 16,302 bases '''
    amps = generator.panel_around(group.region_spans(), 25 + 150)
    assert len(amps) == 41
    assert sum(b - a + 1 for a, b in amps) == 16302
    return amps


def clean(name, count, amps, off_target=0.0):
    ''' the configuration on the panel, with no substitution but the
        strain's planted markers and no sequencing error '''
    config = small(name, count)
    config['reads'].update(compression='none', panel=amps,
                           off_target=off_target)
    config['model'].update(error_rate=0.0, snp_rate=0.0, window_snps=0,
                           resistance_snps=[0, 0])
    return config


def strain_text(genome, planted):
    text = bytearray(generator.BASES[genome].tobytes())
    for p, b in planted:
        text[p - 1] = ord(b)
    return bytes(text)


def locate(text, amps, seq):
    ''' (amplicon, 0-based start in the genome, minus strand) of each
        place ``seq`` lies wholly inside an amplicon (a few stretches
        repeat: the rpoC amplicon and the rrs one share some) '''
    out = []
    for k, (a, b) in enumerate(amps):
        amp = text[a - 1:b]
        for minus, s in ((False, seq), (True, revcomp(seq))):
            at = amp.find(s)
            while at >= 0:
                out.append((k, a - 1 + at, minus))
                at = amp.find(s, at + 1)
    return out


def test_single_reads_lie_inside_one_amplicon(genome, group, panel,
                                              tmp_path):
    config = clean('mtbc_se101', 3000, panel)
    paths, planted = generator.make_sample(genome, group, config, 2 ** 34,
                                           0, str(tmp_path))
    text = strain_text(genome, planted)
    for _, seq, _, _ in records(paths[0]):
        assert locate(text, panel, seq), seq


def test_pairs_lie_inside_one_amplicon_read_inward(genome, group, panel,
                                                   tmp_path):
    config = clean('mtbc_pe150_gz', 1500, panel)
    paths, planted = generator.make_sample(genome, group, config,
                                           2 ** 34 + 1, 0, str(tmp_path))
    text = strain_text(genome, planted)
    f = config['reads']['fragment']
    def fragments(one, two):
        ''' the fragments the mates' places make: one amplicon, mates on
            opposite strands reading inward '''
        for k1, p1, m1 in one:
            for k2, p2, m2 in two:
                lo, hi = (p1, p2) if not m1 else (p2, p1)
                if k1 == k2 and m1 != m2 and lo <= hi:
                    yield k1, lo, hi + 150, m1

    minus_first = 0
    for (_, s1, _, _), (_, s2, _, _) in zip(records(paths[0]),
                                            records(paths[1])):
        found = list(fragments(locate(text, panel, s1),
                               locate(text, panel, s2)))
        assert found, (s1, s2)
        k, lo, hi, m1 = found[0]
        a, b = panel[k]
        assert max(150, f['min']) <= hi - lo <= min(f['max'], b - a + 1)
        assert a - 1 <= lo and hi <= b
        minus_first += m1
    assert 0.4 < minus_first / 1500 < 0.6


def test_reads_follow_the_amplicons_lengths(genome, group, panel,
                                            tmp_path):
    n = 12000
    config = clean('mtbc_se101', n, panel)
    paths, planted = generator.make_sample(genome, group, config,
                                           2 ** 34 + 2, 0, str(tmp_path))
    text = strain_text(genome, planted)
    counts = np.zeros(len(panel))
    for _, seq, _, _ in records(paths[0]):
        # a read of a repeat, shared among the amplicons it lies in
        where = {k for k, _, _ in locate(text, panel, seq)}
        for k in where:
            counts[k] += 1 / len(where)
    lens = np.array([b - a + 1 for a, b in panel], float)
    want = n * lens / lens.sum()
    assert (np.abs(counts - want) < 5 * np.sqrt(want) + 1).all()
    # the longest amplicons draw the most
    assert counts[lens.argmax()] > 2 * counts[lens.argmin()]


def test_off_target_reads_land_outside_the_panel(genome, group, panel,
                                                 tmp_path):
    n, share = 6000, 0.3
    config = clean('mtbc_se101', n, panel, off_target=share)
    paths, planted = generator.make_sample(genome, group, config,
                                           2 ** 34 + 3, 0, str(tmp_path))
    text = strain_text(genome, planted)
    off = sum(not locate(text, panel, seq)
              for _, seq, _, _ in records(paths[0]))
    # off-target reads fall in the panel by chance once in about 250
    assert abs(off / n - share * (1 - 16302 / len(genome))) \
        < 4 * np.sqrt(share * (1 - share) / n)


@pytest.mark.parametrize('name', ['mtbc_se101', 'mtbc_pe150_gz'])
def test_panel_sample_same_bytes_whatever_the_threads(genome, group, panel,
                                                      tmp_path, monkeypatch,
                                                      name):
    monkeypatch.setattr(generator, 'BLOCK', 700)
    config = small(name, 2000)
    config['reads'].update(panel=panel, off_target=0.05)
    os.makedirs(tmp_path / 'b')
    a, _ = generator.make_sample(genome, group, config, 2 ** 40 + 5, 0,
                                 str(tmp_path), threads=4)
    b, _ = generator.make_sample(genome, group, config, 2 ** 40 + 5, 0,
                                 str(tmp_path / 'b'), threads=1)
    for x, y in zip(a, b):
        assert open(x, 'rb').read() == open(y, 'rb').read()


@pytest.mark.parametrize('amp,what', [
    ([1000, 1099], 'shorter than a read'),
    ([0, 500], 'not inside the genome'),
    ([4411400, 4411600], 'not inside the genome'),
    ([600, 400], 'not inside the genome')],
    ids=['short', 'before', 'after', 'reversed'])
def test_a_bad_amplicon_is_named(genome, group, tmp_path, amp, what):
    config = small('mtbc_se101', 100)
    config['reads']['panel'] = [[5000, 5400], amp]
    with pytest.raises(ValueError, match='amplicon 1 .*' + what):
        generator.make_sample(genome, group, config, 1, 0, str(tmp_path))


# the sha256 of each configuration's sample 1 of seed 2**33 + 25 as two
# blocks of 1,000 and 500 reads (pairs), inflated where it is gzip: taken
# before the panel came, so that no configuration's input moved with it
DIGESTS = {
    'mtbc_se101':
        'de02463cd4ada2d197138cef6b78e1c7fb0f1e27b862296ccf23670910063536',
    'mtbc_pe150_gz':
        '396048f5b4bde3e7c49a0bcd4d737855e91a009f5f0bcd14c1b3e89e4c02065f',
    'mtbc_se101_e4':
        'de02463cd4ada2d197138cef6b78e1c7fb0f1e27b862296ccf23670910063536',
}


@pytest.mark.parametrize('name', sorted(DIGESTS))
def test_the_configurations_samples_are_unchanged(genome, group, tmp_path,
                                                  monkeypatch, name):
    monkeypatch.setattr(generator, 'BLOCK', 1000)
    config = small(name, 1500)
    paths, _ = generator.make_sample(genome, group, config, 2 ** 33 + 25, 1,
                                     str(tmp_path), threads=2)
    digest = hashlib.sha256()
    for path in paths:
        data = open(path, 'rb').read()
        if config['reads']['compression'] == 'gzip':
            # a member a block
            assert data.count(b'\x1f\x8b\x08') >= 2
        digest.update(refengine.read_stream([path]))
    assert digest.hexdigest() == DIGESTS[name]
