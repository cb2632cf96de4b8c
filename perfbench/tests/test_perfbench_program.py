'''
The program's spans and counters on the trace's clock
(``perfbench/lib/program.py``): placement, each layer's reading on two
canned samples, the labels of what held the host, and nothing read from
a program without the recorder.
'''

import json

import pytest

from perfbench.lib import program

BASE = 1_000_000_000   # baseTimeNanoseconds of the canned trace
W, M, R = program.WORKER, program.MAIN, program.READER


def ns(us):
    return BASE + int(us * 1e3)


# two samples' profiling.collect(), times in us on the trace's clock
COLLECTED = [
    {'spans': [('cli.load', M, ns(0), ns(10)),
               ('cli.scan', M, ns(10), ns(100)),
               ('analyse.coverages', W, ns(12), ns(14)),
               ('engine.bank', W, ns(14), ns(20)),
               ('engine.wait', W, ns(20), ns(60)),
               ('reader.next', R, ns(15), ns(55)),
               ('engine.match', W, ns(60), ns(70)),
               ('engine.emit', W, ns(70), ns(80)),
               ('analyse.replay', W, ns(80), ns(90)),
               ('cli.analyse', M, ns(100), ns(105)),
               ('cli.write', M, ns(105), ns(120)),
               ('analyse.encode', M, ns(106), ns(110))],
     'counts': {'reader.sieve_ns': 30_000, 'reader.inflate_ns': 0,
                'reader.records': 100, 'reader.survivors': 7}},
    {'spans': [('cli.load', M, ns(200), ns(204)),
               ('engine.bank', W, ns(210), ns(212)),
               ('engine.wait', W, ns(212), ns(250)),
               ('reader.next', R, ns(212), ns(230)),
               ('engine.match', W, ns(250), ns(256)),
               ('cli.write', M, ns(260), ns(265))],
     'counts': {'reader.sieve_ns': 50_000, 'reader.inflate_ns': 0,
                'reader.records': 120, 'reader.survivors': 9}},
]


@pytest.fixture
def samples():
    return [program.place(c, BASE) for c in COLLECTED]


def test_place_on_the_trace_clock(samples):
    assert samples[0]['spans'][0] == ('cli.load', M, 0.0, 10.0)
    assert samples[1]['spans'][-1] == ('cli.write', M, 260.0, 265.0)
    assert samples[1]['counts']['reader.records'] == 120


@pytest.mark.parametrize('metric,want_us', [
    ('load_ms', (10 + 2 + 4) / 2),
    ('write_ms', (15 + 5) / 2),
    ('replay_ms', 10 / 2),
    ('bank_ms', (6 + 2) / 2),
    ('wait_ms', (40 + 38) / 2),
    ('emit_ms', 10 / 2),
    ('read_ms', (40 + 18) / 2),
    ('sieve_ms', (30 + 50) / 2),
])
def test_layer_readings(samples, metric, want_us):
    assert program.layer_ms(samples, metric) == pytest.approx(want_us / 1e3)


def test_engine_parts_on_the_worker(samples):
    # bank + wait + match + emit: 66 us and 46 us
    assert program.span_ms(samples, program.ENGINE_PARTS, W) == \
        pytest.approx((66 + 46) / 2 / 1e3)
    assert program.span_ms(samples, ('cli.load',), W) is None
    assert program.span_ms(samples, ('engine.scan',)) is None


@pytest.mark.parametrize('metric', sorted(program.SPANS)
                         + sorted(program.COUNTERS))
def test_a_program_without_the_recorder_reads_nothing(metric):
    assert program.layer_ms(None, metric) is None
    assert program.layer_ms([], metric) is None
    assert program.label_at(None, 30.0) is None


def test_a_counter_no_sample_holds_reads_nothing(samples):
    for p in samples:
        del p['counts']['reader.inflate_ns']
    assert program.layer_ms(samples, 'inflate_ms') is None


@pytest.mark.parametrize('t,want', [
    (5.0, 'cli.load'),
    (13.0, 'analyse.coverages'),           # the worker before cli.scan
    (30.0, 'engine.wait / reader.next'),
    (58.0, 'engine.wait'),                 # the reader waits to hand over
    (75.0, 'engine.emit'),
    (95.0, 'cli.scan'),                    # the worker done, the main waits
    (108.0, 'analyse.encode'),             # the innermost
    (115.0, 'cli.write'),
    (150.0, None),
    (240.0, 'engine.wait'),
])
def test_labels(samples, t, want):
    assert program.label_at(samples, t) == want


def test_spans_line_up_with_a_real_trace(tmp_path):
    ''' a span of the program lands on the torch.profiler event it
        encloses, through the file's baseTimeNanoseconds '''
    torch = pytest.importorskip('torch')
    from torch.profiler import ProfilerActivity, profile, record_function
    from kvarq_tpu_torch import profiling
    with profiling.recording():
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with profiling.span('cli.write'):
                with record_function('perfbench.inner'):
                    torch.ones(100).sum()
        collected = profiling.collect()
    path = str(tmp_path / 'trace.json')
    prof.export_chrome_trace(path)
    with open(path) as fd:
        data = json.load(fd)
    inner, = [e for e in data['traceEvents']
              if e.get('name') == 'perfbench.inner' and e.get('ph') == 'X']
    placed = program.place(collected, int(data['baseTimeNanoseconds']))
    # the span, named for the calling thread, holds the event's middle
    (name, thread, s, e), = placed['spans']
    placed['spans'] = [(name, M, s, e)]
    mid = float(inner['ts']) + float(inner['dur']) / 2
    assert program.label_at([placed], mid) == 'cli.write'
    assert s - 1e3 < float(inner['ts']) and mid < e + 1e3
