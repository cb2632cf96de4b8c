'''
The port's native reader over a paired gzip run (``_1`` and ``_2``, each
multi-member gzip): the second mate decodes while the first is parsed
(``open_ahead`` in kvarq_tpu_torch/csrc/reader.cpp), and nothing of that
may show.  The batches equal, byte for byte, those of the same pair
decompressed to plain files; the statistics equal the JAX package's
reader's; a corrupt, truncated or missing second mate ends the scan as the
JAX package's reader ends it, after the same batches; the progress
estimate of the second mate is not thrown by its being decoded already.
A reader library built from older source is never loaded.  CPU only.
'''

import gzip
import os
import subprocess
import time

import numpy as np
import pytest

from kvarq_tpu.engine import native as jnative
from kvarq_tpu.engine import reader as jreader
from kvarq_tpu_torch import profiling
from kvarq_tpu_torch.engine import native, reader

AMIN = ord('!') + 13
MINREADLENGTH = 25
BATCH = 4096
# the fast decoder's chunk: the most a ring pushes past a full budget
CHUNK = 1 << 20


def _records(rng, n, start):
    ''' ``n`` FastQ records of 150 bases, 1% of their qualities below -Q 13 '''
    seqs = rng.choice(np.frombuffer(b'ACGTN', np.uint8), size=(n, 150),
                      p=[0.249, 0.249, 0.249, 0.249, 0.004])
    quals = rng.integers(ord('!') + 20, ord('!') + 41, size=(n, 150),
                         dtype=np.uint8)
    low = rng.random((n, 150)) < 0.01
    quals[low] = ord('!') + 5
    return b''.join(b'@r%d\n%s\n+\n%s\n' % (start + i, s.tobytes(),
                                            q.tobytes())
                    for i, (s, q) in enumerate(zip(seqs, quals)))


def _write_gz(path, data, member=256 * 1024):
    ''' ``data`` as multi-member gzip, a member every ``member`` bytes '''
    with open(path, 'wb') as fd:
        for lo in range(0, len(data), member):
            fd.write(gzip.compress(data[lo:lo + member], compresslevel=1))


@pytest.fixture(scope='module')
def mates():
    ''' the two mates' FastQ bytes: 50,000 records each, 17 MB, more than
        the reader takes at a time '''
    rng = np.random.default_rng(19)
    return _records(rng, 50000, 0), _records(rng, 50000, 50000)


def _pair(tmp_path, one, two, plain=False):
    paths = [str(tmp_path / ('reads_%d.fastq' % i + ('' if plain else '.gz')))
             for i in (1, 2)]
    for path, data in zip(paths, (one, two)):
        if plain:
            with open(path, 'wb') as fd:
                fd.write(data)
        else:
            _write_gz(path, data)
    return paths


def _run(batches, fnames, progress=None, **kw):
    ''' every batch as bytes, the statistics, and the error that ended the
        scan (None at a clean end); ``progress`` gets each batch's last
        offset with the statistics' parsed and total bytes.  The consumer
        pauses after the first batch, so that a decoder running ahead
        gets the time to fill '''
    stats = jreader.ReaderStats() if batches is jnative.batches \
        else reader.ReaderStats()
    out, error = [], None
    try:
        for i, b in enumerate(batches(fnames, AMIN, MINREADLENGTH, stats,
                                      batchsize=BATCH, **kw)):
            out.append((b.codes.tobytes(), b.rl.tobytes(),
                        b.filepos.tobytes(), b.raw.tobytes()))
            if progress is not None:
                progress.append((int(b.filepos[-1]), stats.parsed,
                                 stats.total))
            if i == 0:
                time.sleep(0.3)
    except (reader.FastqFormatError, jreader.FastqFormatError) as e:
        error = str(e)
    return out, stats, error


def _stats(s):
    return (s.records_parsed, s.parsed, s.total, s.rls_longest,
            s.rls.tolist())


def _port(fnames, nthreads, monkeypatch, budget=None, progress=None):
    ''' the port's run with its reader's counters; ``budget`` is given to
        the reader through kvq_set_ahead_budget before its first batch '''
    if budget is not None:
        lib = native.get_lib()
        kvq_open = lib.kvq_open

        def open_with_budget(*args):
            h = kvq_open(*args)
            lib.kvq_set_ahead_budget(h, budget)
            return h
        monkeypatch.setattr(lib, 'kvq_open', open_with_budget)
    with profiling.recording():
        got = _run(native.batches, fnames, progress, nthreads=nthreads)
        counts = profiling.collect()['counts']
    monkeypatch.undo()
    return got, counts


CASES = {
    # name: (how _1 and _2 are cut, what is done to _2, budget)
    'pair': ('whole', None, None),
    'record_across_mates': ('across', None, None),
    'budget_full': ('whole', None, 1),
    'corrupt_2': ('whole', 'corrupt', None),
    'truncated_2': ('whole', 'truncated', None),
    'missing_2': ('whole', 'missing', None),
}


@pytest.mark.parametrize('nthreads', [1, 4])
@pytest.mark.parametrize('case', list(CASES))
def test_paired_gz_reads_as_its_plain_pair(tmp_path, monkeypatch, mates,
                                           case, nthreads):
    cut, fault, budget = CASES[case]
    one, two = mates
    if cut == 'across':
        # _1 ends inside a record, with no newline: the record runs on
        # into _2
        one, two = one + two[:40], two[40:]
    gz = _pair(tmp_path, one, two)
    if fault == 'corrupt':
        # the second member's first deflate block gets the invalid block
        # type 3, past a valid first member
        with open(gz[1], 'rb') as fd:
            data = bytearray(fd.read())
        second = len(gzip.compress(two[:256 * 1024], compresslevel=1))
        assert data[second:second + 2] == b'\x1f\x8b'
        data[second + 10] |= 0x06
        with open(gz[1], 'wb') as fd:
            fd.write(bytes(data))
    elif fault == 'truncated':
        size = os.path.getsize(gz[1])
        with open(gz[1], 'r+b') as fd:
            fd.truncate(size // 2 + 7)
    elif fault == 'missing':
        os.unlink(gz[1])

    progress = []
    (got, stats, error), counts = _port(gz, nthreads, monkeypatch, budget,
                                        progress)
    # the JAX package's reader with one thread, as the port's tests call it
    ref, ref_stats, ref_error = _run(jnative.batches, gz, nthreads=1)
    assert error == ref_error
    assert got == ref
    assert _stats(stats) == _stats(ref_stats)

    if fault is None:
        assert error is None
        plain, _, _ = _run(native.batches, _pair(tmp_path, one, two, True),
                           nthreads=nthreads)
        assert got == plain
        assert stats.records_parsed == 100000
        # the estimate of the whole stays ahead of what was parsed; once
        # the reader is in _2, decoded in full while it paused inside _1,
        # it is the exact size
        assert all(parsed <= total for _, parsed, total in progress)
        if nthreads == 1 and budget is None:
            assert [total for pos, _, total in progress if pos >= len(one)] \
                == [stats.parsed] * sum(pos >= len(one)
                                        for pos, _, _ in progress)
    else:
        # nothing of _2 is raised early: every full batch of _1 came first
        assert len(got) >= 50000 // BATCH
        if fault == 'truncated':
            assert error is None
        else:
            assert gz[1] in error
    # the second mate was decoded ahead, within its budget
    ahead = counts['reader.ahead_bytes']
    if fault == 'missing':
        assert ahead == 0
    else:
        assert 0 <= ahead <= len(two)
        if nthreads == 1:
            # the consumer paused inside _1: the decoder had the time
            assert ahead > 0
        if budget is not None:
            assert ahead <= CHUNK < len(two)


def test_stale_reader_library_is_never_loaded(tmp_path):
    ''' a library built from other source is found stale before it is
        loaded: a loaded image with unique symbols stays mapped through
        dlclose, and dlopen would hand it back after the rebuild '''
    stale = tmp_path / '_reader.so'
    subprocess.run(['g++', '-O0', '-DKVARQ_NO_ZLIB',
                    '-DKVARQ_SRC_HASH="0000000000000000"', '-shared', '-fPIC',
                    '-pthread', '-o', str(stale), native.SRC], check=True)
    assert native._load_if_current(str(stale), native._src_hash()) is None
    assert not stale.exists()
    with open('/proc/self/maps') as fd:
        assert str(stale) not in fd.read()
