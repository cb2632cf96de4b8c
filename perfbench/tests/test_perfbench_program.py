'''
The program's spans and counters on the trace's clock
(``perfbench/lib/program.py``): placement, each layer's reading on two
canned samples, the labels of what held the host, and nothing read from
a program without the recorder; each metric's reader on them, a reader
of a span no entry names, and the idle gaps of a canned trace labelled
by the program's spans.
'''

import importlib.util
import json

import pytest

from perfbench.lib import harness, program, spec, trace

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
               ('engine.copy', W, ns(61), ns(64)),
               ('engine.copy', W, ns(66), ns(67)),
               ('engine.emit', W, ns(70), ns(80)),
               ('analyse.replay', W, ns(80), ns(90)),
               ('cli.analyse', M, ns(100), ns(105)),
               ('cli.write', M, ns(105), ns(120)),
               ('analyse.encode', M, ns(106), ns(110))],
     'counts': {'reader.sieve_ns': 30_000, 'reader.inflate_ns': 0,
                'reader.records': 100, 'reader.survivors': 7,
                'scan.scored': 30}},
    {'spans': [('cli.load', M, ns(200), ns(204)),
               ('engine.bank', W, ns(210), ns(212)),
               ('engine.wait', W, ns(212), ns(250)),
               ('reader.next', R, ns(212), ns(230)),
               ('engine.match', W, ns(250), ns(256)),
               ('engine.copy', W, ns(252), ns(254)),
               ('cli.write', M, ns(260), ns(265))],
     'counts': {'reader.sieve_ns': 50_000, 'reader.inflate_ns': 0,
                'reader.records': 120, 'reader.survivors': 9,
                'scan.scored': 50}},
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


# --- the readings as the harness records them: the metrics' readers ----------

READERS = {
    'read_ms.cov': (40 + 18) / 2, 'read_ms.hit': (40 + 18) / 2,
    'sieve_ms.cov': (30 + 50) / 2, 'sieve_ms.hit': (30 + 50) / 2,
    'inflate_ms.cov': 0.0,
    'load_ms.cov': (10 + 2 + 4) / 2, 'load_ms.hit': (10 + 2 + 4) / 2,
    'read_ms.card': (40 + 18) / 2, 'load_ms.card': (10 + 2 + 4) / 2,
    'replay_ms.hit': 10 / 2, 'write_ms.hit': (15 + 5) / 2,
    'emit_ms.hit': 10 / 2,
    'copy_ms.cov': (3 + 1 + 2) / 2,
    # rows, not us: the reader's (30 + 50) / 2 rows, as the test divides
    'scored_rows.cov': (30 + 50) / 2 * 1e3,
}
# what a reader reads where ``program`` names none of it
UNNAMED = {'copy_ms.cov': ('engine.copy', None),
           'scored_rows.cov': (None, 'scan.scored')}


def test_every_program_metric_has_a_canned_reading():
    # engine_ms reads the result's info.scantime, not the recording
    names = {m['name'] for m in spec.load()['per_layer']
             if m['source'] in ('program_span', 'program_counter')
             and not m['name'].startswith('engine_ms.')}
    assert names == set(READERS)


@pytest.mark.parametrize('name,want_us', sorted(READERS.items()))
def test_metric_readers_on_the_recorded_samples(samples, name, want_us):
    got = spec.reader(name)({'program': samples})
    assert got == pytest.approx(want_us / 1e3)


@pytest.mark.parametrize('name', sorted(READERS))
def test_metric_readers_read_nothing_unrecorded(samples, name):
    read = spec.reader(name)
    assert read({'program': None}) is None
    assert read({'program': []}) is None
    # no sample holds the span or counter the metric reads
    key = name.split('.')[0]
    span, counter = UNNAMED.get(name, (None, program.COUNTERS.get(key)))
    gone = set(program.SPANS.get(key, ())) | {span}
    for p in samples:
        p['spans'] = [s for s in p['spans'] if s[0] not in gone]
        p['counts'].pop(counter, None)
    assert read({'program': samples}) is None


def test_a_reader_of_a_span_no_entry_names(samples, tmp_path):
    ''' a later metric on a new span is a reader file alone '''
    assert not any('engine.match' in v for v in program.SPANS.values())
    path = tmp_path / 'match_ms.hit.py'
    path.write_text('from perfbench.lib import program\n\n\n'
                    'def read(record):\n'
                    "    return program.span_ms(record['program'],\n"
                    "                           ('engine.match',))\n")
    loader = importlib.util.spec_from_file_location('match_ms_hit', path)
    module = importlib.util.module_from_spec(loader)
    loader.loader.exec_module(module)
    assert module.read({'program': samples}) == pytest.approx((10 + 6) / 2e3)
    assert module.read({'program': None}) is None


@pytest.fixture
def canned(tmp_path):
    ''' a trace of the two samples: s0 over 0..130 us, s1 over 195..270,
        one kernel inside engine.match (62..68) '''
    events = [
        {'ph': 'X', 'cat': 'user_annotation', 'name': 'perfbench.sample.s0',
         'ts': 0, 'dur': 130},
        {'ph': 'X', 'cat': 'user_annotation', 'name': 'perfbench.sample.s1',
         'ts': 195, 'dur': 75},
        {'ph': 'X', 'cat': 'kernel', 'name': 'cand_screen_kernel', 'ts': 62,
         'dur': 6},
    ]
    path = tmp_path / 'trace.json'
    path.write_text(json.dumps({'traceEvents': events,
                                'baseTimeNanoseconds': BASE}))
    return trace.reduce(str(path))


def test_idle_gaps_carry_the_programs_span(canned):
    samples = [program.place(c, canned['base_ns']) for c in COLLECTED]
    assert sorted(trace.idle_gaps(canned, samples)) == sorted([
        ('in sample.s0 / engine.wait / reader.next', 62.0),  # mid 31
        ('in sample.s0 / cli.scan', 62.0),                   # mid 99
        ('between samples', 65.0),
        ('in sample.s1 / engine.wait', 75.0),                # mid 232.5
    ])
    # without the program's spans, the sample's alone
    assert {g for g, _ in trace.idle_gaps(canned)} == {
        'in sample.s0', 'between samples', 'in sample.s1'}
    gaps = harness.breakdown(canned, samples)['idle_gaps']
    assert gaps[0] == ['in sample.s1 / engine.wait', pytest.approx(75e-6)]
