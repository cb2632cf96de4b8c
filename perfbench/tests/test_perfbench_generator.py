'''
The sample generator: the same seed gives the same bytes, the read layout
and pairing are as the configuration states, gzip is several members, and
reads come from the strain.
'''

import gzip
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
