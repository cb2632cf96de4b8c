'''
The port's tracing (kvarq_tpu_torch.profiling): spans and counters
recorded from the scan's three threads on the clock of a torch.profiler
trace, nothing recorded and the same result while recording is off, the
native reader's counters against its statistics and batches, ``tic`` /
``toc``, and the spans merged into ``scan --profile``'s trace.  CPU
only.
'''

import gzip
import json
import logging
import os
import sys
import threading
import time

import numpy as np
import pytest

from kvarq_tpu_torch import analyse, cli, log, profiling
from kvarq_tpu_torch import engine as tengine
from kvarq_tpu_torch import testsuites as ttestsuites
from kvarq_tpu_torch.engine import native, reader
from kvarq_tpu_torch.engine.sieve import KmerSieve

from _torch_log import restore_log_levels  # noqa: F401

HERE = os.path.abspath(os.path.dirname(__file__))
TESTSUITES = os.path.join(os.path.dirname(HERE), 'testsuites')
FASTQ = os.path.join(HERE, 'fastqs', 'L3_N1014_hits_5k.fastq')

# the thread that calls cli.main (the test's), the scan's, the reader's
MAIN, WORKER, READER = 'main', 'analyse-thread', 'kvarq-reader-prefetch'
# the spans each thread of a scan records, coverage scan and scan -H
SPANS = {
    'cov': {MAIN: {'cli.load', 'cli.scan', 'cli.analyse', 'cli.write'},
            WORKER: {'analyse.coverages', 'engine.bank', 'engine.wait',
                     'engine.scan', 'engine.fold'},
            READER: {'reader.next'}},
    'hits': {MAIN: {'cli.load', 'cli.scan', 'cli.analyse', 'cli.write',
                    'analyse.encode'},
             WORKER: {'analyse.coverages', 'engine.bank', 'engine.wait',
                      'engine.match', 'engine.emit', 'analyse.replay'},
             READER: {'reader.next'}},
}


@pytest.fixture(autouse=True)
def reset_torch_engine_config():
    tengine.config(maxerrors=0, minoverlap=20, minreadlength=10,
                   nthreads=1, Amin='!', Azero='!', device='cpu',
                   backend='device', sieve='auto', batchsize=16384)
    yield
    tengine.config(backend='device')


def _scan(tmp_path, name, extra=()):
    ''' the CLI's MTBC scan of the fixture on the CPU, four reader
        threads and small batches; :returns: its result '''
    out = str(tmp_path / name)
    cli.main(['-q', '-t', TESTSUITES, 'scan', '-l', 'MTBC', '--backend',
              'cpu', '-t', '4', '--variant', 'Illumina 1.8+'] + list(extra)
             + ['-f', FASTQ, out])
    with open(out) as fd:
        return json.load(fd)


def _by_thread(spans):
    ''' {thread: [(name, start, end)]}, the calling thread's as MAIN '''
    out = {}
    me = threading.current_thread().name
    for name, thread, start, end in spans:
        out.setdefault(MAIN if thread == me else thread, []).append(
            (name, start, end))
    return out


def test_recording_off_records_nothing_and_changes_no_result(tmp_path):
    off = _scan(tmp_path, 'off.json')
    assert profiling.collect() == {'spans': [], 'counts': {}}
    with profiling.recording():
        on = _scan(tmp_path, 'on.json')
        rec = profiling.collect()
    assert rec['spans'] and rec['counts']
    for data in (off, on):
        del data['info']['scantime'], data['info']['when']
    assert on == off
    assert not profiling.is_recording()


@pytest.mark.parametrize('path', ['cov', 'hits'])
def test_scan_records_its_spans_nested_on_three_threads(tmp_path, path):
    with profiling.recording():
        data = _scan(tmp_path, 'r.json', ['-H'] if path == 'hits' else [])
        rec = profiling.collect()
    threads = _by_thread(rec['spans'])
    for thread, names in SPANS[path].items():
        assert names <= {n for n, _, _ in threads[thread]}, thread
    other = ({'engine.match', 'engine.emit', 'analyse.replay'}
             if path == 'cov' else {'engine.scan', 'engine.fold'})
    assert not other & {n for n, _, _ in threads[WORKER]}
    for thread, spans in threads.items():
        stack = []
        for name, start, end in sorted(spans, key=lambda s: (s[1], -s[2])):
            assert start <= end
            while stack and stack[-1][2] <= start:
                stack.pop()
            # a span that starts inside another ends inside it
            assert not stack or end <= stack[-1][2], (thread, name,
                                                      stack[-1][0])
            stack.append((name, start, end))
    # the engine's spans on the worker fill the engine's own time
    engine = sum(e - s for n, s, e in threads[WORKER]
                 if n.startswith('engine.')) / 1e9
    assert 0.9 * data['info']['scantime'] <= engine \
        <= data['info']['scantime']
    assert rec['counts']['reader.records'] \
        == data['stats']['records_parsed']


def _mtbc_sieve():
    suites = ttestsuites.load_testsuites(
        ttestsuites.discover_testsuites([TESTSUITES]), ['MTBC'])
    covs = analyse.Analyser().load_coverages(suites, spacing=25)
    seqs = [c.plus_seq.bases for c in covs.values()] \
        + [c.minus_seq.bases for c in covs.values()]
    return KmerSieve.build(seqs, 2, 25, 25)


def _batches(fname, sieve, nthreads):
    ''' the native reader's batches of ``fname`` at -Q 13 (Illumina 1.8+),
        with its statistics '''
    stats = reader.ReaderStats()
    out = [(b.codes.tobytes(), b.rl.tobytes(), b.filepos.tobytes(),
            b.raw.tobytes())
           for b in native.batches([fname], ord('!') + 13, 25, stats,
                                   batchsize=64, sieve=sieve,
                                   nthreads=nthreads)]
    return out, stats


@pytest.mark.parametrize('nthreads', [1, 4])
@pytest.mark.parametrize('gz', [False, True], ids=['plain', 'gz'])
def test_native_reader_profile_changes_no_batch(tmp_path, gz, nthreads):
    ''' batches byte for byte the same with the reader's profile on and
        off; its times count only when it is on, its records and
        survivors are the statistics' and the batches' '''
    fname = FASTQ
    if gz:
        fname = str(tmp_path / 'reads.fastq.gz')
        with open(FASTQ, 'rb') as src, gzip.open(fname, 'wb') as dst:
            dst.write(src.read())
    sieve = _mtbc_sieve()
    off, _ = _batches(fname, sieve, nthreads)
    assert profiling.collect()['counts'] == {}
    with profiling.recording():
        on, stats = _batches(fname, sieve, nthreads)
        counts = profiling.collect()['counts']
    assert on == off
    assert counts['reader.records'] == stats.records_parsed == 1250
    assert counts['reader.survivors'] \
        == sum(len(rl) // 4 for _, rl, _, _ in on) > 0
    assert counts['reader.survivors'] < counts['reader.records']
    assert counts['reader.sieve_ns'] > 0
    assert (counts['reader.inflate_ns'] > 0) == gz

    # the counters with the profile off: no time, the same counts
    lib = native.get_lib()
    names = (native.ctypes.c_char_p * 1)(fname.encode())
    h = lib.kvq_open(names, 1, ord('!') + 13, 25, nthreads, 0, 1)
    # the reader keeps pointers into these until kvq_close
    arrays = [np.ascontiguousarray(a, dtype=t) for a, t in (
        (sieve.start, np.int32), (sieve.gpos, np.int32),
        (sieve.gtid, np.int32), (sieve.tstart, np.int32),
        (sieve.tstop, np.int32), (sieve.bank_codes, np.uint8))]
    lib.kvq_set_sieve(h, *arrays, sieve.k, sieve.t, sieve.m,
                      sieve.maxerrors)
    raw = np.zeros((64, 1024), np.uint8)
    codes = np.zeros((64, 1024), np.uint8)
    rl = np.zeros(64, np.int32)
    fp = np.zeros(64, np.int64)
    lpad = native.ctypes.c_int32()
    while lib.kvq_next(h, 64, 1024, codes, raw.ctypes.data, rl, fp,
                       native.ctypes.byref(lpad)) > 0:
        pass
    got = np.zeros(len(native.PROF_COUNTERS), np.int64)
    lib.kvq_prof(h, got)
    lib.kvq_close(h)
    # a gzip file of one member: the chain passes through it alone
    assert list(got) == [0, 0, counts['reader.records'],
                         counts['reader.survivors'], 0, 0, int(gz), 0, 0]
    assert counts['reader.ahead_bytes'] == 0
    assert counts['reader.members'] == int(gz)
    assert counts['reader.members_parallel'] == 0
    assert counts['reader.spec_dropped_bytes'] == 0


@pytest.mark.parametrize('nthreads', [1, 4])
@pytest.mark.parametrize('kind', ['plain', 'gz', 'paired_gz'])
def test_native_reader_counts_the_bytes_decoded_ahead(tmp_path, kind,
                                                      nthreads):
    ''' reader.ahead_bytes: the second gzip mate's bytes decoded before
        the reader reached it, none for a plain file or a single gzip
        file '''
    mates = [os.path.join(HERE, 'fastqs', 'L3_N1014_hits_500_%d.fastq' % i)
             for i in (1, 2)]
    fnames = [FASTQ]
    if kind != 'plain':
        fnames = []
        for src in [FASTQ] if kind == 'gz' else mates:
            fnames.append(str(tmp_path / (os.path.basename(src) + '.gz')))
            with open(src, 'rb') as fd, gzip.open(fnames[-1], 'wb') as dst:
                dst.write(fd.read())
    stats = reader.ReaderStats()
    with profiling.recording():
        for i, _ in enumerate(native.batches(fnames, ord('!') + 13, 25,
                                             stats, batchsize=64,
                                             nthreads=nthreads)):
            if i == 0:
                # the first mate's reader pauses: a decoder running
                # ahead gets the time to fill
                time.sleep(0.3)
        counts = profiling.collect()['counts']
    ahead = counts['reader.ahead_bytes']
    if kind != 'paired_gz':
        assert ahead == 0
        return
    # with worker threads the reader may reach _2 before its decoder
    # queued anything; with one it paused inside _1, where nothing of _2
    # is read
    assert 0 <= ahead <= os.path.getsize(mates[1])
    if nthreads == 1:
        assert ahead == os.path.getsize(mates[1])


@pytest.mark.parametrize('nthreads', [1, 4])
def test_native_reader_counts_the_consumers_wait(tmp_path, monkeypatch,
                                                 nthreads):
    ''' reader.consumer_wait_ns: the time kvq_next waited for the
        workers' next item, counted once a scan inside recording() alone
        and never above the scan's ``reader.next`` spans.  The input is a
        FIFO whose writer waits 0.2 s before it writes, so the workers
        hold the consumer at least that long; one thread has no workers
        and waits for none '''
    with open(FASTQ, 'rb') as fd:
        data = fd.read()
    fifo = str(tmp_path / 'reads.fastq')
    os.mkfifo(fifo)
    counted = []
    count = profiling.count
    monkeypatch.setattr(profiling, 'count', lambda name, n: (
        counted.append(name), count(name, n)))

    def write():
        with open(fifo, 'wb') as fd:
            time.sleep(0.2)
            fd.write(data)

    def scan(fname):
        return sum(len(b) for b in native.batches(
            [fname], ord('!') + 13, 25, reader.ReaderStats(), batchsize=64,
            nthreads=nthreads))

    writer = threading.Thread(target=write)
    writer.start()
    with profiling.recording():
        reads = scan(fifo)
        rec = profiling.collect()
    writer.join(timeout=30)
    assert not writer.is_alive()
    assert reads == scan(FASTQ) > 64
    assert counted.count('reader.consumer_wait_ns') == 1
    wait = rec['counts']['reader.consumer_wait_ns']
    nexts = sum(end - start for name, _, start, end in rec['spans']
                if name == 'reader.next')
    if nthreads == 1:
        assert wait == 0
    else:
        assert 0.15e9 < wait <= nexts

    # outside recording() nothing is counted
    del counted[:]
    assert scan(FASTQ) == reads
    assert counted == []
    assert profiling.collect() == {'spans': [], 'counts': {}}


def test_span_lines_up_with_record_function(tmp_path):
    ''' a span and a record_function of one thread agree on the
        profiler's clock (the event's ts plus the file's
        baseTimeNanoseconds): with nothing between their boundaries but
        the two contexts' own entry and exit, each boundary of the one
        lies within 1 ms of the other's.  record_function is entered once
        before the profile: its first entry in a process sets itself up
        before its event starts (0.25-0.4 ms on a loaded 8-core host,
        against 0.04-0.06 ms after), the longest part of the window
        between the two clocks' readings '''
    from torch.profiler import ProfilerActivity, profile, record_function
    with record_function('test.warm'):
        pass
    with profiling.recording():
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with profiling.span('test.outer'):
                with record_function('test.inner'):
                    pass
        rec = profiling.collect()
    path = str(tmp_path / 'trace.json')
    prof.export_chrome_trace(path)
    with open(path) as fd:
        data = json.load(fd)
    base = int(data['baseTimeNanoseconds'])
    inner, = [e for e in data['traceEvents']
              if e.get('name') == 'test.inner' and e.get('ph') == 'X']
    start = base + 1e3 * float(inner['ts'])
    end = start + 1e3 * float(inner['dur'])
    (name, thread, a, b), = rec['spans']
    assert (name, thread) == ('test.outer', threading.current_thread().name)
    assert a - 1e6 < start <= end < b + 1e6
    assert abs(start - a) < 1e6 and abs(b - end) < 1e6


def test_profile_trace_holds_the_reader_thread(tmp_path):
    ''' --profile: info.phases keeps its keys, and the exported trace
        holds the program's spans under their threads' names '''
    data = _scan(tmp_path, 'p.json', ['--profile', str(tmp_path / 'tr')])
    assert set(data['info']['phases']) == {'scan', 'analyse', 'total'}
    assert not profiling.is_recording()
    assert profiling.collect() == {'spans': [], 'counts': {}}
    with open(tmp_path / 'tr' / profiling.TRACE_FILE) as fd:
        events = json.load(fd)['traceEvents']
    tids = {e['args']['name']: e['tid'] for e in events
            if e.get('ph') == 'M' and e.get('name') == 'thread_name'}
    tids[MAIN] = tids[threading.current_thread().name]
    spans = {(e['name'], e['tid']) for e in events
             if e.get('cat') == 'kvarq'}
    assert ('reader.next', tids[READER]) in spans
    assert ('engine.scan', tids[WORKER]) in spans
    assert ('cli.load', tids[MAIN]) in spans
    assert any('aten::' in str(e.get('name')) for e in events)


def test_tic_toc_time_through_spans(caplog):
    caplog.set_level(logging.DEBUG, logger='kvarq_tpu_torch')
    log.set_debug()
    try:
        with profiling.recording():
            log.tic('test.block')
            log.toc('test.block')
            rec = profiling.collect()
    finally:
        log.set_info()
    assert [s[0] for s in rec['spans']] == ['test.block']
    assert 'toc-tic test.block' in caplog.text
    assert log._open['test.block'] == []
    assert not hasattr(log, 'tictocs')


def test_recorder_off_is_a_shared_no_op():
    assert not profiling.is_recording()
    assert profiling.span('a') is profiling.span('b')
    profiling.count('a', 1)
    with profiling.span('a'):
        pass
    assert profiling.collect() == {'spans': [], 'counts': {}}
    with profiling.recording():
        with profiling.recording():
            profiling.count('c', 2)
            with profiling.span('inner'):
                pass
        assert profiling.is_recording()
        profiling.count('c', 3)
        assert profiling.collect()['counts'] == {'c': 5}
        assert profiling.collect() == {'spans': [], 'counts': {}}
        profiling.count('dropped', 1)
    # what the outermost block left uncollected is gone
    assert not profiling.is_recording()
    assert profiling.collect() == {'spans': [], 'counts': {}}


def test_recorder_loses_nothing_across_threads():
    ''' more threads than cores, switching often: every span and every
        count arrives '''
    nthreads, n = 4 * (os.cpu_count() or 1), 300
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profiling.recording():
            def work():
                for _ in range(n):
                    with profiling.span('s'):
                        profiling.count('c', 1)
            threads = [threading.Thread(target=work, name='t%d' % i)
                       for i in range(nthreads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
            rec = profiling.collect()
    finally:
        sys.setswitchinterval(interval)
    assert rec['counts'] == {'c': nthreads * n}
    assert len(rec['spans']) == nthreads * n
    assert {s[1] for s in rec['spans']} == {t.name for t in threads}
