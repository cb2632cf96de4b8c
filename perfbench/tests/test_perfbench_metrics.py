'''
Each metric reader on a canned record: spans of the window and a small
Chrome trace of two traced samples.
'''

import json

import pytest

from perfbench.lib import harness, spec, trace

# two traced samples (10..110 us and 120..220 us on the trace's clock),
# three kernels, a copy, and a host op that is not device activity
EVENTS = [
    {'ph': 'X', 'cat': 'user_annotation', 'name': 'perfbench.sample.s0',
     'ts': 10, 'dur': 100},
    {'ph': 'X', 'cat': 'user_annotation', 'name': 'perfbench.sample.s1',
     'ts': 120, 'dur': 100},
    {'ph': 'X', 'cat': 'kernel', 'name': 'score_step_kernel', 'ts': 20,
     'dur': 10},
    {'ph': 'X', 'cat': 'kernel', 'name': 'score_step_kernel', 'ts': 25,
     'dur': 10},
    {'ph': 'X', 'cat': 'gpu_memcpy', 'name': 'Memcpy DtoH', 'ts': 140,
     'dur': 20},
    {'ph': 'X', 'cat': 'kernel', 'name': 'cand_screen_kernel', 'ts': 200,
     'dur': 40},
    {'ph': 'X', 'cat': 'cpu_op', 'name': 'aten::empty', 'ts': 30, 'dur': 50},
    {'ph': 'i', 'cat': 'kernel', 'name': 'marker', 'ts': 30},
]


BASE = 1_000_000_000   # the trace's baseTimeNanoseconds


@pytest.fixture
def canned(tmp_path):
    path = tmp_path / 'trace.json'
    path.write_text(json.dumps({'traceEvents': EVENTS,
                                'baseTimeNanoseconds': BASE}))
    return trace.reduce(str(path))


def record(tr=None):
    return {
        'reads_per_sample': 1000,
        'setup_s': 12.5,
        'window_s': 2.0,
        'scans': [{'sample': 0, 'wall_s': 0.5, 'scantime_s': 0.3, 'rc': 0},
                  {'sample': 1, 'wall_s': 0.7, 'scantime_s': 0.5, 'rc': 0},
                  {'sample': 0, 'wall_s': 0.6, 'scantime_s': None, 'rc': 1}],
        'trace': tr,
        'program': None,
    }


def test_trace_reduction(canned):
    assert canned['base_ns'] == BASE
    assert trace.window(canned) == (10.0, 220.0)
    assert trace.samples(canned) == 2
    # 20..35, 140..160, 200..220 (the last kernel clipped at the window)
    assert trace.busy_intervals(canned) == [(20.0, 35.0), (140.0, 160.0),
                                            (200.0, 220.0)]
    assert trace.busy_us(canned) == 55.0
    assert trace.us_by_name(canned, ('kernel',)) == {
        'score_step_kernel': 20.0, 'cand_screen_kernel': 20.0}
    gaps = dict()
    for label, us in trace.idle_gaps(canned):
        gaps[label] = gaps.get(label, 0) + us
    assert gaps == {'in sample.s0': 10 + 75, 'between samples': 10,
                    'in sample.s1': 20 + 40}


@pytest.mark.parametrize('name,want', [
    ('cov_reads_per_s', 3 * 1000 / 2.0),
    ('hit_reads_per_s', 3 * 1000 / 2.0),
    ('wall_reads_per_s.card', 3 * 1000 / 2.0),
    ('cli_ms.card', 200.0),
    ('engine_ms.card', 400.0),
    ('setup_s', 12.5),
    ('cli_ms.cov', 200.0),
    ('cli_ms.hit', 200.0),
    ('engine_ms.cov', 400.0),
    ('engine_ms.hit', 400.0),
])
def test_window_readers(name, want):
    assert spec.reader(name)(record()) == pytest.approx(want)


SHARED = {'cli_ms', 'engine_ms', 'kernel_ms', 'device_idle_pct', 'read_ms',
          'sieve_ms', 'load_ms'}


@pytest.mark.parametrize('cell,suffix,other,own', [
    ('mtbc_se101.cov', '.cov', '.hit', set()),
    ('mtbc_pe150_gz.cov', '.cov', '.hit', {'inflate_ms'}),
    ('mtbc_se101.hits', '.hit', '.cov', {'replay_ms', 'write_ms', 'emit_ms'}),
])
def test_cells_report_only_their_paths_layer_metrics(cell, suffix, other,
                                                     own):
    # BENCHMARK.json's workloads decide; the readers do not look
    names = [m['name'] for m in spec.metrics(spec.load(), cell, True)]
    assert SHARED | own == \
        {n[:-len(suffix)] for n in names if n.endswith(suffix)}
    assert not [n for n in names if n.endswith(other)]


@pytest.mark.parametrize('suffix', ['cov', 'hit', 'card'])
def test_trace_readers(canned, suffix):
    rec = record(canned)
    # 40 us of kernels over two samples
    assert spec.reader('kernel_ms.' + suffix)(rec) == pytest.approx(0.02)
    assert spec.reader('device_idle_pct.' + suffix)(rec) == \
        pytest.approx(100 * (1 - 55 / 210))


@pytest.mark.parametrize('name', ['kernel_ms.cov', 'device_idle_pct.cov',
                                  'kernel_ms.hit', 'device_idle_pct.hit',
                                  'kernel_ms.card', 'device_idle_pct.card',
                                  'card_kernel_ms'])
def test_trace_readers_without_a_trace_read_nothing(name):
    assert spec.reader(name)(record()) is None


def test_card_kernel_ms_reads_every_kernel_of_the_window(canned):
    # the window's trace has no sample spans: every kernel counts, over
    # the window's three scans; copies and host ops do not
    rec = record()
    rec['window_trace'] = canned
    assert spec.reader('card_kernel_ms')(rec) == \
        pytest.approx((10 + 10 + 40) / 3 / 1e3)
    rec['scans'] = []
    assert spec.reader('card_kernel_ms')(rec) is None
    rec = record()
    rec['window_trace'] = dict(canned, device=[
        d for d in canned['device'] if d[1] != 'kernel'])
    assert spec.reader('card_kernel_ms')(rec) is None


class Event:
    ''' what ``trace.device_activity`` reads of a profiler event '''

    def __init__(self, name, cuda, start_us, dur_us):
        from torch.autograd import DeviceType
        self._name, self._start, self._dur = name, start_us, dur_us
        self._type = DeviceType.CUDA if cuda else DeviceType.CPU

    def name(self):
        return self._name

    def device_type(self):
        return self._type

    def start_ns(self):
        return int(self._start * 1e3)

    def duration_ns(self):
        return int(self._dur * 1e3)


def test_device_activity_from_the_profilers_events():
    tr = trace.device_activity([
        Event('cudaLaunchKernel', False, 5, 2),
        Event('void cand_screen_kernel<4>()', True, 30, 40),
        Event('Memcpy HtoD (Pageable -> Device)', True, 10, 5),
        Event('Memset (Device)', True, 20, 1),
        Event('score_step_kernel', True, 80, 10)])
    assert tr['device'] == [
        ('Memcpy HtoD (Pageable -> Device)', 'gpu_memcpy', 10.0, 15.0),
        ('Memset (Device)', 'gpu_memset', 20.0, 21.0),
        ('void cand_screen_kernel<4>()', 'kernel', 30.0, 70.0),
        ('score_step_kernel', 'kernel', 80.0, 90.0)]
    rec = record()
    rec['window_trace'] = tr
    assert spec.reader('card_kernel_ms')(rec) == pytest.approx(50 / 3 / 1e3)


def test_only_an_untraced_window_with_a_device_metric_is_profiled():
    bench = spec.load()
    device = {m['name'] for m in bench['end_to_end']
              if m['source'] == 'device_trace'}
    assert device == {'card_kernel_ms'}
    profiled = {w['name'] for w in bench['workloads']
                if device & {m['name'] for m in
                             spec.metrics(bench, w['name'], False)}}
    assert profiled == {'mtbc_se101_e4.cov'}


@pytest.mark.parametrize('name', ['cov_reads_per_s', 'cli_ms.cov',
                                  'engine_ms.hit', 'wall_reads_per_s.card'])
def test_window_readers_without_scans_read_nothing(name):
    rec = record()
    rec['scans'] = []
    assert spec.reader(name)(rec) is None


def test_breakdown_lists_ops_and_gaps(canned):
    b = harness.breakdown(canned)
    assert sorted(b['device_ops']) == [
        ['Memcpy DtoH', pytest.approx(20e-6)],
        ['cand_screen_kernel', pytest.approx(20e-6)],
        ['score_step_kernel', pytest.approx(20e-6)]]
    assert len(b['idle_gaps']) <= 10
    assert b['idle_gaps'][0] == ['in sample.s0', pytest.approx(75e-6)]
