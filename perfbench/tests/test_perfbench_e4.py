'''
The sieve-less deployment ``mtbc_se101_e4`` (``kvarq scan -e 4``) and its
cell ``mtbc_se101_e4.cov``: a run on the CPU at a small count is correct
and each fault of ``test_perfbench_faults.py`` makes it not correct; K1's
work (``perfbench/lib/roofline.py``) and the cell's three metrics of the
sparse path on canned traces and counters, None where the run holds
nothing to read (a program without the counters); and the metrics the
cell reports.
'''

import json

import pytest

from perfbench.lib import harness, program, roofline, spec, trace
from test_perfbench_faults import altered, half_batches, stale

ROOT = spec.ROOT
BENCH = spec.load()
CELL = 'mtbc_se101_e4.cov'
BASE = 1_000_000_000   # baseTimeNanoseconds of the canned trace


def run(tmp_path, monkeypatch, count=4000):
    monkeypatch.setenv('TMPDIR', str(tmp_path))
    monkeypatch.setattr('tempfile.tempdir', None)
    config = spec.config('mtbc_se101_e4')
    config['reads']['count'] = count
    return harness.execute(ROOT, BENCH, CELL, 2 ** 31 + 11, 0.1, False,
                           card=False, config=config)


def test_the_configuration_is_mtbc_se101_at_four_mismatches():
    e4, se = spec.config('mtbc_se101_e4'), spec.config('mtbc_se101')
    assert e4['scan'] == dict(se['scan'], errors=4)
    assert e4['reads'] == se['reads'] and e4['model'] == se['model']
    assert e4['reduced'] == [] and 'errors' in e4['assumed']
    argv = harness.cli_argv(e4, spec.traffic('cov'), 'a.fq', 'a.json')
    assert argv[argv.index('-e') + 1] == '4'


def test_sound_run_is_correct(tmp_path, monkeypatch):
    result = run(tmp_path, monkeypatch)
    assert result['correct'], result['checks']
    assert result['failed'] == 0 and result['attempted'] >= 3


@pytest.mark.parametrize('fault', [stale, half_batches, altered],
                         ids=['state-unchanged', 'half-batch', 'altered'])
def test_broken_path_is_not_correct(fault, tmp_path, monkeypatch):
    fault(monkeypatch)
    result = run(tmp_path, monkeypatch)
    assert not result['correct']
    assert result['failed'] > 0
    assert any(c['value'] > c['limit'] for c in result['checks'].values())


def test_q_of_the_mtbc_templates_at_101_bases():
    config = spec.config('mtbc_se101_e4')
    lengths = [len(s) for s in
               harness.reference_group(config, ROOT).sequences()]
    assert len(lengths) == 264
    assert roofline.columns(101, lengths) == 39036
    ops, nbytes = roofline.screen_work(101, lengths)
    assert (ops, nbytes) == (2 * 4 * 101 * 39036, 105)


# two traced samples (10..110 us and 120..220 us), K1 in both, S1 and a
# copy beside it, and K1 reaching past the window's end
EVENTS = [
    {'ph': 'X', 'cat': 'user_annotation', 'name': 'perfbench.sample.s0',
     'ts': 10, 'dur': 100},
    {'ph': 'X', 'cat': 'user_annotation', 'name': 'perfbench.sample.s1',
     'ts': 120, 'dur': 100},
    {'ph': 'X', 'cat': 'kernel', 'name': 'cand_screen_kernel', 'ts': 20,
     'dur': 30},
    {'ph': 'X', 'cat': 'kernel', 'name': 'score_step_kernel', 'ts': 55,
     'dur': 10},
    {'ph': 'X', 'cat': 'gpu_memcpy', 'name': 'Memcpy HtoD (Pageable)',
     'ts': 130, 'dur': 5},
    {'ph': 'X', 'cat': 'kernel', 'name': 'void cand_screen_kernel<4>()',
     'ts': 200, 'dur': 40},
]
# each sample's profiling.collect() as placed on the trace's clock
PROGRAM = [
    {'spans': [('engine.scan', program.WORKER, 15.0, 60.0),
               ('engine.copy', program.WORKER, 16.0, 19.0),
               ('engine.copy', program.WORKER, 40.0, 41.0)],
     'counts': {'scan.screened': 1000, 'scan.scored': 30,
                'scan.h2d_bytes': 105_000, 'reader.records': 1000}},
    {'spans': [('engine.scan', program.WORKER, 125.0, 219.0),
               ('engine.copy', program.WORKER, 126.0, 128.0)],
     'counts': {'scan.screened': 3000, 'scan.scored': 50,
                'scan.h2d_bytes': 315_000, 'reader.records': 3000}},
]


@pytest.fixture
def canned(tmp_path):
    path = tmp_path / 'trace.json'
    path.write_text(json.dumps({'traceEvents': EVENTS,
                                'baseTimeNanoseconds': BASE}))
    return trace.reduce(str(path))


def record(tr, samples):
    return {'reads_per_sample': 2000, 'setup_s': 1.0, 'window_s': 2.0,
            'scans': [], 'trace': tr, 'program': samples}


def test_k1_roofline_reads_the_share(canned):
    config = spec.config('mtbc_se101_e4')
    lengths = [len(s) for s in
               harness.reference_group(config, ROOT).sequences()]
    # 4,000 reads screened in 30 + 20 us of K1 (the second clipped)
    ops = 4000 * 2 * 4 * 101 * 39036
    want = 100 * (ops / 1979e12) / 50e-6
    got = spec.reader('K1_roofline.cov')(record(canned, PROGRAM))
    assert got == pytest.approx(want)
    assert got == pytest.approx(roofline.share(4000, 50.0, 101, lengths))
    # operations-bound: the bytes' share is far below
    assert 4000 * 105 / 3.35e12 < ops / 1979e12


def test_k1_roofline_reads_none_without_what_it_reads(canned):
    read = spec.reader('K1_roofline.cov')
    parent = [{'spans': [], 'counts': {'reader.records': 1000}}] * 2
    assert read(record(None, PROGRAM)) is None
    assert read(record(canned, None)) is None
    assert read(record(canned, parent)) is None
    no_k1 = dict(canned, device=[d for d in canned['device']
                                 if 'cand_screen' not in d[0]])
    assert read(record(no_k1, PROGRAM)) is None


def test_k1_roofline_needs_one_configuration(canned):
    bench = json.loads(json.dumps(BENCH))
    entry, = [m for m in bench['per_layer']
              if m['name'] == 'K1_roofline.cov']
    rec = record(canned, PROGRAM)
    assert roofline.k1_roofline(rec, 'K1_roofline.cov', bench) is not None
    entry['workloads'] = [CELL, 'mtbc_se101.cov']
    assert roofline.k1_roofline(rec, 'K1_roofline.cov', bench) is None
    entry['workloads'] = [CELL, 'mtbc_se101.cov', 'mtbc_se101.hits']
    assert roofline.k1_roofline(rec, 'K1_roofline.cov', bench) is None
    del entry['workloads']
    assert roofline.k1_roofline(rec, 'K1_roofline.cov', bench) is None


def test_scored_rows_and_copy_ms_read_the_samples(canned):
    rec = record(canned, PROGRAM)
    assert spec.reader('scored_rows.cov')(rec) == pytest.approx(40.0)
    # (3 + 1) and 2 us of copies: 3 us a sample
    assert spec.reader('copy_ms.cov')(rec) == pytest.approx(0.003)


@pytest.mark.parametrize('name', ['scored_rows.cov', 'copy_ms.cov'])
def test_sparse_path_readers_read_none_from_a_program_without_them(name):
    parent = [{'spans': [('engine.scan', program.WORKER, 1.0, 2.0)],
               'counts': {'reader.records': 1000}}]
    assert spec.reader(name)(record(None, parent)) is None
    assert spec.reader(name)(record(None, None)) is None


def test_the_cell_reports_its_metrics():
    assert [w for w in BENCH['workloads'] if w['name'] == CELL] == [
        dict(name=CELL, config='mtbc_se101_e4', traffic='cov', chips=1,
             why=spec.cell(BENCH, CELL)['why'])]
    # the card's kernel time stands end to end: the host's regimes spread
    # the wall rate past any bound, so it is a per-layer reading here
    e2e = {m['name'] for m in spec.metrics(BENCH, CELL, False)}
    assert e2e == {'card_kernel_ms', 'setup_s'}
    layer = {m['name'] for m in spec.metrics(BENCH, CELL, True)}
    assert layer == {'wall_reads_per_s.card', 'cli_ms.card',
                     'engine_ms.card', 'kernel_ms.card',
                     'device_idle_pct.card', 'read_ms.card', 'load_ms.card',
                     'K1_roofline.cov', 'scored_rows.cov', 'copy_ms.cov'}
    for m in BENCH['per_layer']:
        if m['name'] in layer:
            assert m['workloads'] == [CELL]
            assert m['moves'] == 'card_kernel_ms'
