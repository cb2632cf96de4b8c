'''
The port's native reader hands the engine finished rows
(kvarq_tpu_torch/csrc/reader.cpp): one kvq_next call writes a batch's rows
at the batch's width, with the reads' bytes or without them.  Held against
the JAX package's numpy reader, batch by batch and field by field; the
coverage scan at -e 4, which asks for no bytes, against the JAX package's
scan; the host memory of a gzip scan whose sieve passes nothing, which
holds no more than the reader's windows; and the gzip member pool's hold on
memory, within the reader's ahead budget.  CPU only.
'''

import gzip
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from kvarq_tpu import engine as jengine
from kvarq_tpu.engine import reader as jreader
from kvarq_tpu.engine.encode import CODE_READ_JUNK
from kvarq_tpu.engine.sieve import KmerSieve as JKmerSieve
from kvarq_tpu_torch import engine as tengine
from kvarq_tpu_torch import profiling
from kvarq_tpu_torch.engine import native, reader, tensor_scan
from kvarq_tpu_torch.engine.sieve import KmerSieve

HERE = os.path.abspath(os.path.dirname(__file__))
ROOT = os.path.dirname(HERE)
FASTQ = os.path.join(HERE, 'fastqs', 'L3_N1014_hits_5k.fastq')
TEMPLATE = 'GATCCGTACGGTTCAGCATGCCTAGGACTTGCAAGTCGATCGGATACCGTTAGCAATGCC'
AMIN = ord('!') + 13

pytestmark = pytest.mark.skipif(
    not native.available(), reason="the port's native reader is unavailable")


def _fastq(path, long_reads, gz):
    ''' 600 reads of 30 to 190 bases, so that the widths 64, 128 and 192
        meet in one batch, qualities that trim some of them, every 41st
        read's bases drawn from every byte value but the newline, the
        template planted in every fifth read; with ``long_reads`` every
        97th read takes 1,100 to 1,500 bases (kvq_next's -2 path) '''
    rng = np.random.RandomState(22)
    acgtn = np.frombuffer(b'ACGTACGTACGTN', np.uint8)
    every = np.array([b for b in range(256) if b != ord('\n')], np.uint8)
    tmpl = np.frombuffer(TEMPLATE.encode(), np.uint8)
    recs = []
    for i in range(600):
        L = rng.randint(1100, 1501) if long_reads and i % 97 == 50 \
            else rng.randint(30, 191)
        seq = rng.choice(acgtn, L)
        if i % 41 == 7:
            head = rng.permutation(every)[:L]
            seq[:len(head)] = head
        if i % 5 == 0 and L >= len(tmpl):
            at = rng.randint(0, L - len(tmpl) + 1)
            seq[at:at + len(tmpl)] = tmpl
        qual = np.full(L, ord('I'), np.uint8)
        if L < 1100:
            qual[rng.rand(L) < 0.015] = ord('#')
        recs.append(b'@r%d\n%s\n+\n%s\n' % (i, seq.tobytes(),
                                              qual.tobytes()))
    data = b''.join(recs)
    with (gzip.open if gz else open)(path, 'wb') as fd:
        fd.write(data)


def _at_native_cuts(batches, batchsize):
    ''' the reads of ``batches`` cut where the native reader cuts them:
        every ``batchsize`` reads that reach it (the sieve drops reads
        before), and before a read wider than the rows so far (its -2
        return), each batch padded to the width of its longest read '''
    reads = [(b.codes[i, :r], b.raw[i, :r], r, p) for b in batches
             for i, (r, p) in enumerate(zip(b.rl, b.filepos))]
    cuts, cur, stride = [], [], native.MAX_READLENGTH
    for read in reads:
        if jreader._round_up(read[2]) > stride:
            stride = jreader._round_up(read[2])
            if cur:
                cuts.append(cur)
                cur = []
        cur.append(read)
        if len(cur) == batchsize:
            cuts.append(cur)
            cur = []
    if cur:
        cuts.append(cur)
    out = []
    for cut in cuts:
        rl = np.array([r for _, _, r, _ in cut], np.int32)
        Lpad = jreader._round_up(int(rl.max()))
        codes = np.full((len(cut), Lpad), CODE_READ_JUNK, np.uint8)
        raw = np.zeros((len(cut), Lpad), np.uint8)
        for i, (c, w, r, _) in enumerate(cut):
            codes[i, :r], raw[i, :r] = c, w
        out.append(jreader.RecordBatch(
            codes, rl, np.array([p for _, _, _, p in cut], np.int64), raw))
    return out


@pytest.mark.parametrize('raw', [True, False], ids=['raw', 'codes'])
@pytest.mark.parametrize('sieve', [False, True], ids=['all', 'sieve'])
@pytest.mark.parametrize('nthreads', [1, 8])
@pytest.mark.parametrize('gz', [False, True], ids=['plain', 'gz'])
@pytest.mark.parametrize('long_reads', [False, True], ids=['short', 'long'])
def test_handoff_rows(tmp_path, monkeypatch, long_reads, gz, nthreads,
                      sieve, raw):
    ''' every batch the port's native reader yields equals the JAX
        package's numpy reader's, cut at the same reads, field by field
        (codes with their pad, rl, filepos, raw where asked, ``None`` where
        not); the batches are all held before they are compared, so that a
        buffer used again shows '''
    path = str(tmp_path / ('reads.fastq.gz' if gz else 'reads.fastq'))
    _fastq(path, long_reads, gz)
    batchsize = 32
    s1, s2 = reader.ReaderStats(), jreader.ReaderStats()
    got = list(native.batches(
        [path], AMIN, 25, s1, batchsize,
        sieve=KmerSieve.build([TEMPLATE], 2, 25, 25) if sieve else None,
        nthreads=nthreads, raw=raw))
    monkeypatch.setenv('KVARQ_NATIVE', '0')
    want = list(jreader.batches(
        [path], AMIN, 25, s2, batchsize,
        sieve=JKmerSieve.build([TEMPLATE], 2, 25, 25) if sieve else None))
    cut = _at_native_cuts(want, batchsize)
    if not (sieve or long_reads):
        # no read dropped, no row widened: the JAX reader's own cuts
        assert [len(b) for b in cut] == [len(b) for b in want]
    assert len(got) == len(cut) > 2
    # reads of the widths 64, 128 and 192 in one batch
    assert any({64, 128, 192} <= {jreader._round_up(int(r)) for r in b.rl}
               for b in got)
    widest = max(b.codes.shape[1] for b in got)
    assert long_reads == (widest > native.MAX_READLENGTH)
    for i, (x, y) in enumerate(zip(got, cut)):
        assert x.codes.dtype == np.uint8 and x.codes.flags.c_contiguous
        np.testing.assert_array_equal(x.codes, y.codes, err_msg=str(i))
        np.testing.assert_array_equal(x.rl, y.rl)
        np.testing.assert_array_equal(x.filepos, y.filepos)
        if raw:
            np.testing.assert_array_equal(x.raw, y.raw, err_msg=str(i))
        else:
            assert x.raw is None
    for x, y in zip(got, got[1:]):
        assert not np.may_share_memory(x.codes, y.codes)
    assert s1.records_parsed == s2.records_parsed == 600
    np.testing.assert_array_equal(s1.rls, s2.rls)
    assert s1.rls_longest == s2.rls_longest
    if sieve:
        assert 0 < sum(len(b) for b in got) < 300


def test_countseqs_reads_no_raw_rows(monkeypatch):
    ''' the coverage scan at -e 4 (no sieve) on the CPU hands its scanner
        batches without raw rows, and its base counts are the JAX
        package's numpy scan's over the same file and templates, and those
        of the same scan over batches that carry raw rows '''
    for eng in (tengine, jengine):
        monkeypatch.setattr(eng, '_config', dict(eng._config))
        monkeypatch.setattr(eng, '_extra_config', dict(eng._extra_config))
    params = dict(maxerrors=4, minoverlap=25, minreadlength=25,
                  Amin=chr(AMIN))
    tengine.config(nthreads=4, device='cpu', backend='device', sieve='auto',
                   batchsize=256, **params)
    with open(FASTQ) as fd:
        lines = fd.read().split('\n')
    # stretches of three of the fixture's reads
    seqs = [lines[4 * i + 1][5:65] for i in (0, 300, 900)]
    raws = []
    scan_batch = tensor_scan.TensorScanner.scan_batch

    def seen(self, batch):
        raws.append(batch.raw)
        return scan_batch(self, batch)

    monkeypatch.setattr(tensor_scan.TensorScanner, 'scan_batch', seen)
    got = tengine.countseqs(FASTQ, seqs)
    assert len(raws) > 1 and all(r is None for r in raws)

    # the JAX package's numpy path: its hit list folded to base counts
    monkeypatch.setattr(jengine, 'SMALL_SCAN_BYTES', 1 << 40)
    monkeypatch.setattr(jengine, '_jax_device_ready', lambda: False)
    jengine.config(backend='auto', nthreads=1, **params)
    want = jengine.countseqs(FASTQ, seqs)
    assert got['stats'] == want['stats']
    assert sum(int(c.sum()) for c in want['basecounts']) > 0
    for a, b in zip(got['basecounts'], want['basecounts']):
        np.testing.assert_array_equal(a, b)

    batches = tengine._batches
    monkeypatch.setattr(tengine, '_batches',
                        lambda fnames, sieve, raw: batches(fnames, sieve,
                                                           raw=True))
    raws.clear()
    with_raw = tengine.countseqs(FASTQ, seqs)['basecounts']
    assert raws and all(r is not None for r in raws)
    for a, b in zip(with_raw, want['basecounts']):
        np.testing.assert_array_equal(a, b)


# drains a FastQ through the native reader with the sieve of TEMPLATE and
# prints the growth of the resident set over the drain, in bytes
# drains a FastQ through the native reader with the sieve of TEMPLATE and
# prints the reads passed and the growth of the resident set over the
# drain, in kB (VmHWM is this process's own: getrusage's maximum would
# start from the forking process's)
DRAIN = '''
import sys
from kvarq_tpu_torch.engine import native, reader
from kvarq_tpu_torch.engine.sieve import KmerSieve

def status(key):
    with open('/proc/self/status') as fd:
        return next(int(line.split()[1]) for line in fd
                    if line.startswith(key + ':'))

native.get_lib()
sieve = KmerSieve.build([sys.argv[2]], 2, 25, 25)
before = status('VmRSS')
n = sum(len(b) for b in native.batches(
    [sys.argv[1]], 46, 25, reader.ReaderStats(), 16384, sieve=sieve,
    nthreads=4, raw=False))
print(n, status('VmHWM') - before)
'''


def test_sieved_gzip_scan_holds_no_sample(tmp_path):
    ''' a gzip sample of 256 MB of FastQ in which the sieve passes no read:
        one kvq_next call drains it to the end, and the reader holds its
        windows (the decoder's 32-MB ring, the workers' spans), not the
        sample, while it does '''
    rec = b'@r\n%s\n+\n%s\n' % (b'A' * 101, b'I' * 101)
    chunk = rec * ((4 << 20) // len(rec))
    path = str(tmp_path / 'polya.fastq.gz')
    with gzip.open(path, 'wb', compresslevel=1) as fd:
        for _ in range(64):
            fd.write(chunk)
    size = 64 * len(chunk)
    out = subprocess.run(
        [sys.executable, '-c', DRAIN, path, TEMPLATE], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    n, grown = map(int, out.stdout.split())
    assert n == 0
    assert grown * 1024 < size // 2, (grown, size)


# DRAIN with the reader's ahead budget set (kvq_set_ahead_budget) to
# sys.argv[3] bytes where that is not 0; prints the reads passed, the
# records parsed and the growth of the resident set over the drain, in kB
DRAIN_BUDGET = '''
import sys
from kvarq_tpu_torch.engine import native, reader
from kvarq_tpu_torch.engine.sieve import KmerSieve

def status(key):
    with open('/proc/self/status') as fd:
        return next(int(line.split()[1]) for line in fd
                    if line.startswith(key + ':'))

lib = native.get_lib()
budget = int(sys.argv[3])
kvq_open = lib.kvq_open

def open_with_budget(*args):
    h = kvq_open(*args)
    if budget:
        lib.kvq_set_ahead_budget(h, budget)
    return h
lib.kvq_open = open_with_budget
sieve = KmerSieve.build([sys.argv[2]], 2, 25, 25)
stats = reader.ReaderStats()
before = status('VmRSS')
n = sum(len(b) for b in native.batches(
    [sys.argv[1]], 46, 25, stats, 16384, sieve=sieve,
    nthreads=4, raw=False))
print(n, stats.records_parsed, status('VmHWM') - before)
'''


def test_member_pool_holds_its_budget(tmp_path):
    ''' a gzip sample of 128 MB of FastQ in members of 8 MB, read with an
        ahead budget of one byte: the member pool still decodes it to the
        end, one member at a time beyond the head, and the reader's
        resident set grows by no more than the same sample's as a single
        member (the usual ring and windows) plus one member, and 32 MB for
        the allocator and the threads' timing, which move that growth by
        as much from run to run.  Without a budget the pool decodes the
        sample ahead, and the growth passes the single member's by 80 to
        140 MB '''
    rec = b'@r\n%s\n+\n%s\n' % (b'A' * 101, b'I' * 101)
    data = rec * ((4 << 20) // len(rec)) * 32
    member = 8 << 20
    grown = {}
    for name, size in (('single', len(data)), ('members', member)):
        path = str(tmp_path / ('%s.fastq.gz' % name))
        with open(path, 'wb') as fd:
            for lo in range(0, len(data), size):
                fd.write(gzip.compress(data[lo:lo + size], compresslevel=1))
        out = subprocess.run(
            [sys.executable, '-c', DRAIN_BUDGET, path, TEMPLATE,
             '1' if name == 'members' else '0'], cwd=ROOT,
            capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr
        n, records, grown[name] = map(int, out.stdout.split())
        assert n == 0
        assert records == len(data) // len(rec)
    assert grown['members'] * 1024 \
        <= grown['single'] * 1024 + member + (32 << 20), grown


def _polya(mb):
    ''' ``mb`` MB of FastQ records of 101 A's '''
    rec = b'@r\n%s\n+\n%s\n' % (b'A' * 101, b'I' * 101)
    return rec * ((mb << 20) // len(rec))


@pytest.mark.parametrize('kind', ['large', 'understated'])
def test_member_pool_bounds_a_large_member(tmp_path, kind):
    ''' members of 128 MB, four times the one member that the pool decodes
        beyond the head whatever the budget (a ring's usual 32 MB), read
        with an ahead budget of one byte.  ``large``: two such members,
        whose ISIZE the pool reads, so it leaves the second to the head.
        ``understated``: a stored member of 128 MB between two of 8 MB,
        whose first record's header holds four zero bytes and a gzip
        header: the pool takes the zeros for the member's ISIZE, starts it
        and gives it up to the head once it passes 32 MB.  Either way the
        resident set grows by no more than the same bytes' as one member,
        plus the one member beyond the head and 32 MB for the allocator
        and the threads' timing.  Were the pool to decode the large member
        whole, it would grow by 128 MB more '''
    big = _polya(128)
    if kind == 'large':
        parts = [(big, 1), (big, 1)]
    else:
        small = _polya(8)
        fake = b'@\0\0\0\0\x1f\x8b\x08\0\0\0\0\0\0\xff%s\n%s\n+\n%s\n' % (
            b'x' * 16, b'A' * 101, b'I' * 101)
        parts = [(small, 1), (fake + big, 0), (small, 1)]
    plain = b''.join(data for data, _ in parts)
    members = [gzip.compress(data, compresslevel=level)
               for data, level in parts]
    assert kind == 'large' or b'\0\0\0\0\x1f\x8b\x08' in members[1]
    grown = {}
    for name in ('single', 'members'):
        path = str(tmp_path / ('%s.fastq.gz' % name))
        with open(path, 'wb') as fd:
            if name == 'members':
                fd.write(b''.join(members))
            else:   # at the members' level, so the two map as much
                fd.write(gzip.compress(plain, compresslevel=parts[1][1]))
        out = subprocess.run(
            [sys.executable, '-c', DRAIN_BUDGET, path, TEMPLATE, '1'],
            cwd=ROOT, capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr
        n, records, grown[name] = map(int, out.stdout.split())
        assert n == 0
        assert records == plain.count(b'\n+\n')
    assert grown['members'] * 1024 \
        <= grown['single'] * 1024 + (32 << 20) + (32 << 20), grown


def test_member_pool_shares_the_ahead_budget(tmp_path, monkeypatch):
    ''' a paired run of two multi-member mates, 8 MB and 128 MB in members
        of 1 and 4 MB, read with an ahead budget of 48 MB, whose consumer
        rests after its first batch, so that everything the reader may
        decode ahead is decoded: the second mate's bytes decoded before it
        became current, its ring's and the pool's members together
        (``reader.ahead_bytes``), stay within the one budget, plus a chunk
        of 1 MB for each of the pool's four threads.  With a budget apiece
        they came to about twice it '''
    budget = 48 << 20
    lib = native.get_lib()
    kvq_open = lib.kvq_open

    def open_with_budget(*args):
        h = kvq_open(*args)
        lib.kvq_set_ahead_budget(h, budget)
        return h
    monkeypatch.setattr(lib, 'kvq_open', open_with_budget)
    paths, want = [], 0
    for i, (mb, member) in enumerate(((8, 1), (128, 4))):
        data = _polya(mb)
        want += data.count(b'\n+\n')
        paths.append(str(tmp_path / ('reads_%d.fastq.gz' % (i + 1))))
        with open(paths[-1], 'wb') as fd:
            for lo in range(0, len(data), member << 20):
                fd.write(gzip.compress(data[lo:lo + (member << 20)],
                                       compresslevel=1))
    records = 0
    with profiling.recording():
        for b in native.batches(paths, 46, 25, reader.ReaderStats(), 16384,
                                nthreads=4, raw=False):
            if not records:
                time.sleep(3)
            records += len(b)
        counts = profiling.collect()['counts']
    assert records == want
    assert counts['reader.members_parallel'] > 0
    assert 0 < counts['reader.ahead_bytes'] <= budget + (4 << 20), counts
