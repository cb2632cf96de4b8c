'''
The port's native reader decodes the members of a mapped multi-member gzip
file on a pool of threads (the member pool of
kvarq_tpu_torch/csrc/reader.cpp), and nothing of that may show.  The
batches equal, byte for byte, those of the same input decompressed to a
plain file; where the input is faulty, those of the JAX package's reader,
ended by the same error after the same batches.  The statistics equal the
JAX package's reader's.  The counters say how far the pool engaged:
``reader.members`` the members the chain passed through,
``reader.members_parallel`` those the pool served, and
``reader.spec_dropped_bytes`` the bytes of false starts.  CPU only, a few
MB an input.
'''

import gzip
import threading

import numpy as np
import pytest

from kvarq_tpu.engine import native as jnative
from kvarq_tpu.engine import reader as jreader
from kvarq_tpu_torch import profiling
from kvarq_tpu_torch.engine import native, reader

AMIN = ord('!') + 13
MINREADLENGTH = 25
BATCH = 2048
# the longest a scan of these inputs may take: a reader whose threads wait
# on each other forever fails the test instead of hanging it
SCAN_SECONDS = 60

pytestmark = pytest.mark.skipif(
    not native.available(), reason="the port's native reader is unavailable")


def _records(seed, n, start=0, head=b''):
    ''' ``n`` FastQ records of 150 bases, 1% of their qualities below -Q
        13; ``head`` is added to every header line '''
    rng = np.random.default_rng(seed)
    seqs = rng.choice(np.frombuffer(b'ACGTN', np.uint8), size=(n, 150),
                      p=[0.249, 0.249, 0.249, 0.249, 0.004])
    quals = rng.integers(ord('!') + 20, ord('!') + 41, size=(n, 150),
                         dtype=np.uint8)
    quals[rng.random((n, 150)) < 0.01] = ord('!') + 5
    return b''.join(b'@r%d%s\n%s\n+\n%s\n' % (start + i, head, s.tobytes(),
                                              q.tobytes())
                    for i, (s, q) in enumerate(zip(seqs, quals)))


def _members(data, cuts, level=4):
    ''' ``data`` as gzip members split at the byte offsets ``cuts`` '''
    bounds = [0] + list(cuts) + [len(data)]
    return [gzip.compress(data[lo:hi], compresslevel=level, mtime=0)
            for lo, hi in zip(bounds, bounds[1:])]


def _record_cuts(data, every):
    ''' the offsets where every ``every``-th record starts '''
    ends = np.flatnonzero(np.frombuffer(data, np.uint8) == ord('\n'))
    return [int(e) + 1 for e in ends[4 * every - 1:-1:4 * every]]


def _run(batches, fnames, nthreads=1):
    ''' every batch as bytes, the statistics, and the error that ended the
        scan (None at a clean end) '''
    stats = jreader.ReaderStats() if batches is jnative.batches \
        else reader.ReaderStats()
    out, error = [], None
    try:
        for b in batches(fnames, AMIN, MINREADLENGTH, stats,
                         batchsize=BATCH, nthreads=nthreads):
            out.append((b.codes.tobytes(), b.rl.tobytes(),
                        b.filepos.tobytes(), b.raw.tobytes()))
    except (reader.FastqFormatError, jreader.FastqFormatError) as e:
        error = str(e)
    return out, (stats.records_parsed, stats.parsed, stats.total,
                 stats.rls_longest, stats.rls.tolist()), error


def _port(fnames, nthreads):
    ''' the port's run, on a thread of its own and within SCAN_SECONDS,
        with its reader's counters '''
    done = []

    def scan():
        with profiling.recording():
            got = _run(native.batches, fnames, nthreads)
            done.append((got, profiling.collect()['counts']))
    t = threading.Thread(target=scan, daemon=True)
    t.start()
    t.join(timeout=SCAN_SECONDS)
    assert done, 'the scan did not end within %d s' % SCAN_SECONDS
    return done[0]


def _stored_false_start():
    ''' records whose header lines hold a whole gzip member (one with no
        newline byte), the whole stored: a start the chain never reaches,
        and whose decode succeeds '''
    for i in range(1000):
        inner = gzip.compress(b'decoy %d\n' % i * 50, mtime=0)
        if b'\n' not in inner:
            break
    data = _records(31, 3000, head=b' ' + inner)
    return data, _members(data, _record_cuts(data, 1000), level=0)


def _mate(name):
    ''' a mate's plain bytes and its gzip members, and what is done to
        them: (plain, members, fault) '''
    data = _records(7, 8000)
    if name == 'one_record':
        data = data[:len(data) // 8]
        return data, _members(data, _record_cuts(data, 1)), None
    if name == 'mid_record':
        return data, _members(data, range(100003, len(data), 300007)), None
    if name == 'stored_false_start':
        return _stored_false_start() + (None,)
    if name == 'single_member':
        return data, _members(data, []), None
    fault = name if name in ('trailing_garbage', 'truncated',
                             'crc_middle') else None
    return data, _members(data, _record_cuts(data, 1500)), fault


CASES = ['one_record', 'many_records', 'mid_record', 'stored_false_start',
         'trailing_garbage', 'truncated', 'crc_middle', 'single_member',
         'paired']


@pytest.mark.parametrize('nthreads', [1, 4])
@pytest.mark.parametrize('case', CASES)
def test_gz_members_read_as_their_plain_file(tmp_path, case, nthreads):
    mates = [_mate(case)]
    if case == 'paired':
        data = _records(8, 6000, start=8000)
        mates = [(mates[0][0], mates[0][1], None),
                 (data, _members(data, _record_cuts(data, 1000)), None)]
    gz, plain = [], []
    for i, (data, members, fault) in enumerate(mates):
        blob = b''.join(members)
        if fault == 'trailing_garbage':
            blob += b'\x00garbage after the last member\n' * 3
        elif fault == 'truncated':
            blob = blob[:len(blob) - len(members[-1]) // 2]
        elif fault == 'crc_middle':
            # the CRC32 of the third of six members
            at = sum(len(m) for m in members[:3]) - 8
            blob = blob[:at] + bytes([blob[at] ^ 0x55]) + blob[at + 1:]
        gz.append(str(tmp_path / ('reads_%d.fastq.gz' % (i + 1))))
        plain.append(str(tmp_path / ('reads_%d.fastq' % (i + 1))))
        with open(gz[-1], 'wb') as fd:
            fd.write(blob)
        with open(plain[-1], 'wb') as fd:
            fd.write(data)

    (got, stats, error), counts = _port(gz, nthreads)
    # the JAX package's reader with one thread, as the port's tests call it
    ref, ref_stats, ref_error = _run(jnative.batches, gz)
    assert error == ref_error
    assert got == ref
    assert stats == ref_stats
    fault = mates[0][2]
    nmembers = sum(len(members) for _, members, _ in mates)
    if fault is None:
        assert error is None
        want, want_stats, _ = _run(native.batches, plain, nthreads)
        assert got == want
        assert stats[0] == want_stats[0]
        assert counts['reader.members'] == nmembers
    elif fault == 'trailing_garbage':
        assert 'incorrect header check' in error
        assert counts['reader.members'] == nmembers
    elif fault == 'truncated':
        assert error is None
        assert counts['reader.members'] == nmembers - 1
    else:
        assert 'incorrect data check' in error
        assert len(got) >= 3 * 1500 // BATCH
        assert counts['reader.members'] == 2
    # every mate's first member is its head's own
    assert 0 <= counts['reader.members_parallel'] \
        <= counts['reader.members'] - len(mates)
    if case == 'single_member':
        assert counts['reader.members'] == 1
        assert counts['reader.members_parallel'] == 0
    if fault in (None, 'trailing_garbage') and case != 'stored_false_start':
        # every start of a sound chain is reached; a faulty member's decode
        # on the pool fails, and its bytes are dropped
        assert counts['reader.spec_dropped_bytes'] == 0


def test_gz_members_decode_on_the_pool(tmp_path):
    ''' while the head decodes a large first member, the pool decodes the
        small ones after it, and the head serves them.  Which members the
        pool finishes first is up to the threads' scheduling, so one of
        three runs has to show it '''
    data = _records(11, 60000)
    first = len(data) - 64 * 1024 * 8
    members = _members(data, range(first, len(data), 64 * 1024), level=1)
    gz = str(tmp_path / 'reads.fastq.gz')
    with open(gz, 'wb') as fd:
        fd.write(b''.join(members))
    want = _run(native.batches, [gz], 4)
    served = []
    for _ in range(3):
        got, counts = _port([gz], 4)
        assert got == want
        assert counts['reader.members'] == len(members) == 9
        served.append(counts['reader.members_parallel'])
        if served[-1]:
            break
    assert 1 <= max(served) <= 8, served


def test_gz_members_with_more_threads_than_cores(tmp_path):
    ''' sixteen reader threads (the member pool takes eight, and each mate
        a head) over a paired run of a thousand members a mate, three
        times: the pool's hand-offs lose nothing and reorder nothing '''
    gz, plain = [], []
    for i in (1, 2):
        data = _records(40 + i, 1000, start=1000 * i)
        gz.append(str(tmp_path / ('reads_%d.fastq.gz' % i)))
        plain.append(str(tmp_path / ('reads_%d.fastq' % i)))
        with open(gz[-1], 'wb') as fd:
            fd.write(b''.join(_members(data, _record_cuts(data, 1))))
        with open(plain[-1], 'wb') as fd:
            fd.write(data)
    want = _run(native.batches, plain, 16)
    for _ in range(3):
        got, counts = _port(gz, 16)
        assert got[0] == want[0]
        assert got[1][0] == want[1][0] == 2000
        assert got[2] is None
        assert counts['reader.members'] == 2000
