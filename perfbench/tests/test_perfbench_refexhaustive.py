'''
The brute-force matcher (``perfbench/lib/refexhaustive.py``) against the
seeded one (``refengine.match``): the same rows at 2, 3 and 4 mismatches
on a generated MTBC sample joined by reads cut from the templates in
every mode, with ``N``, trimmed tails and both strands; and the choice of
matcher in ``check.Expected``.
'''

import os

import numpy as np
import pytest

from perfbench.lib import check, generator, refengine, refexhaustive, spec
from perfbench.reference import MTBC

ROOT = spec.ROOT
GROUP = MTBC.Group(ROOT, 25)
SEQS = GROUP.sequences()


def on_target(n, rng):
    ''' FastQ records of ``n`` reads placed on the templates at shifts
        from a read tail over a template's head to a read head over its
        tail (inside either way, both strands: the minus templates are
        templates), 0 to 5 substitutions, an ``N`` in a third, a
        low-quality stretch to trim in a third '''
    out = []
    for i in range(n):
        seq = SEQS[int(rng.integers(len(SEQS)))]
        length = int(rng.integers(30, 151))
        d = int(rng.integers(-(length - 20), len(seq) - 20))
        read = [seq[i + d] if 0 <= i + d < len(seq) else 'ACGT'[
            int(rng.integers(4))] for i in range(length)]
        for p in rng.integers(0, length, int(rng.integers(0, 6))):
            read[p] = 'ACGT'[('ACGT'.index(read[p]) + 1) % 4]
        if rng.random() < 0.3:
            read[int(rng.integers(length))] = 'N'
        qual = ['I'] * length
        if rng.random() < 0.3:
            a, k = int(rng.integers(length)), int(rng.integers(1, 20))
            qual[a:a + k] = '#' * len(qual[a:a + k])
        out.append('@t%d\n%s\n+\n%s\n' % (i, ''.join(read), ''.join(qual)))
    return ''.join(out).encode()


@pytest.fixture(scope='module')
def records(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('reads')
    config = spec.config('mtbc_se101')
    config['reads']['count'] = 3000
    genome = generator.genome_codes(os.path.join(ROOT, MTBC.GENOME))
    paths, _ = generator.make_sample(genome, GROUP, config, 2 ** 33 + 5, 0,
                                     str(tmp))
    buf = refengine.read_stream(paths) + on_target(800,
                                                   np.random.default_rng(3))
    return refengine.Records(buf, 33 + 13, 25)


@pytest.mark.parametrize('errors', [2, 3, 4])
def test_the_same_rows_as_the_seeded_matcher(records, errors):
    tpl = refengine.Templates(SEQS, errors, 25, 25)
    want = refengine.match(records, tpl, threads=2)
    got = refexhaustive.match(records, tpl, chunk=384)
    # in the seeded matcher's order; every mode met, N inside some reads
    np.testing.assert_array_equal(got, want)
    r, t, d, _ = got.T
    modes = refengine.weights(d, records.rl[r], tpl.lens[t], tpl.mo)
    assert all(m.any() for m in modes)
    width = int(records.rl.max())
    assert (records.codes(0, len(records.rl), width)[np.unique(r)] == 4).any()
    assert (got[:, 3] == errors).any()


def test_no_read_and_every_read_too_far_off(tmp_path):
    tpl = refengine.Templates(SEQS, 4, 25, 25)
    path = tmp_path / 'x.fastq'
    path.write_bytes(b'')
    rec = refengine.Records(refengine.read_stream([str(path)]), 46, 25)
    assert refexhaustive.match(rec, tpl).shape == (0, 4)
    path.write_bytes(b'@a\n' + b'A' * 60 + b'\n+\n' + b'I' * 60 + b'\n')
    rec = refengine.Records(refengine.read_stream([str(path)]), 46, 25)
    assert refexhaustive.match(rec, tpl).shape == (0, 4)


@pytest.mark.parametrize('errors,matcher', [(2, 'refengine'),
                                            (3, 'refexhaustive'),
                                            (4, 'refexhaustive')])
def test_expected_takes_the_seeds_from_eight_bases(tmp_path, monkeypatch,
                                                   errors, matcher):
    ''' k = 25 // (e + 1): 8 at e = 2, every cell of today, matched from
        the seeds as before; 6 and 5 by brute force '''
    config = spec.config('mtbc_se101')
    config['scan']['errors'] = errors
    config['reads']['count'] = 200
    genome = generator.genome_codes(os.path.join(ROOT, MTBC.GENOME))
    paths, _ = generator.make_sample(genome, GROUP, config, 9, 0,
                                     str(tmp_path))
    called = []
    for module in (refengine, refexhaustive):
        real = module.match

        def spy(*args, module=module, real=real, **kw):
            called.append(module.__name__.rsplit('.', 1)[1])
            return real(*args, **kw)
        monkeypatch.setattr(module, 'match', spy)
    check.Expected(paths, config, GROUP)
    assert called == [matcher]


@pytest.mark.parametrize('errors', [2, 4])
def test_expected_takes_the_brute_force_matcher_on_a_card(tmp_path,
                                                          monkeypatch,
                                                          errors):
    ''' on a card every sample is matched by brute force, whatever the
        seed's length: its time does not grow with the reads on target '''
    config = spec.config('mtbc_se101')
    config['scan']['errors'] = errors
    config['reads']['count'] = 200
    genome = generator.genome_codes(os.path.join(ROOT, MTBC.GENOME))
    paths, _ = generator.make_sample(genome, GROUP, config, 9, 0,
                                     str(tmp_path))
    called = []

    def seeded(*args, **kw):
        raise AssertionError('the seeded matcher on a card')

    def brute(rec, tpl, device='cpu', chunk=None):
        called.append(device)
        return np.zeros((0, 4), np.int64)
    monkeypatch.setattr(refengine, 'match', seeded)
    monkeypatch.setattr(refexhaustive, 'match', brute)
    check.Expected(paths, config, GROUP, 'cuda')
    assert called == ['cuda']
