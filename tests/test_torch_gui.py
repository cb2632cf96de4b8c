'''
The port's GUI (kvarq_tpu_torch.gui) against kvarq_tpu's on the CPU:
the display-free helpers on the cases of tests/test_gui.py, and, headless
through tests/faketk.py with its ``GUI_MODULES`` set to the port's
modules, the settings dialog, the main window, the scan -> save ->
explore flow (the port's engine on the CPU; the saved json equals
kvarq_tpu's ``Analyser().scan(...).encode()``), a stopped scan, a scan
that asks for the card on a host without one, the all-zero plot that
kvarq_tpu's ``tkplot`` divides by, and the ``gui`` / ``explorer`` CLI
commands.  Every comparison is exact equality.
'''

import contextlib
import importlib
import json
import logging
import os
import time

import pytest
import torch

import faketk

HERE = os.path.abspath(os.path.dirname(__file__))
ROOT = os.path.dirname(HERE)
TESTSUITES = os.path.join(ROOT, 'testsuites')
MTBC_FASTQ = os.path.join(HERE, 'fastqs', 'N0116_1_hits_1k.fastq')

PKGS = ('kvarq_tpu', 'kvarq_tpu_torch')
GUI = ('util', 'settings', 'tkplot', 'explorer', 'simple', 'main')

needs_genome = pytest.mark.skipif(
    not os.path.exists(os.path.join(TESTSUITES, 'MTBC',
                                    'MTB_ancestor_reference.bases')),
    reason='run tools/reconstruct_genome.py first')


def _mod(pkg, name):
    return importlib.import_module('%s.%s' % (pkg, name))


@contextlib.contextmanager
def headless(pkg):
    ''' faketk installed over ``pkg``'s GUI modules '''
    saved = faketk.GUI_MODULES
    faketk.GUI_MODULES = ['%s.gui.%s' % (pkg, m) for m in GUI]
    try:
        with faketk.installed() as tk:
            yield tk
    finally:
        faketk.GUI_MODULES = saved


@contextlib.contextmanager
def logger_level(pkg, level):
    ''' ``pkg``'s logger at ``level``, put back after '''
    lo = _mod(pkg, 'log').lo
    saved = lo.level
    lo.setLevel(level)
    try:
        yield lo
    finally:
        lo.setLevel(saved)


@pytest.fixture(autouse=True)
def port_engine_on_cpu():
    ''' the port's engine at its defaults, on the CPU '''
    from kvarq_tpu_torch import engine
    engine.config(maxerrors=0, minoverlap=20, minreadlength=10, nthreads=1,
                  Amin='!', Azero='!', device='cpu', sieve='auto', mesh='',
                  batchsize=16384)
    yield


# --- display-free helpers (the cases of tests/test_gui.py) -------------------

def _pairs(pkg, tmp):
    pair = _mod(pkg, 'gui.simple').pair_fastqs
    return [pair(x) for x in (
        ['b_2.fastq', 'b_1.fastq', 'a.fastq'], ['x_1.fastq', 'y_2.fastq'],
        ['c_1.fastq.gz', 'c_2.fastq.gz'],
        ['a_1.fastq', 'a_2.fastq', 'a_3.fastq'])]


def _bins(pkg, tmp):
    tkplot = _mod(pkg, 'gui.tkplot')
    return [tkplot.histogram_bins([1, 1, 2, 4, 5, 3, 3, 1], True, 4),
            tkplot.histogram_bins([3, 1, 4, 1, 5, 9, 2, 6], False, 4),
            [tkplot.nice_bin_width(x) for x in (0, 0.03, 137.2, 2048.7)]]


def _log_lines(pkg, tmp):
    split = _mod(pkg, 'gui.main').split_log_line
    return [split(x) for x in ('[INFO] hello', 'no tag here', '[x', '')]


def _int_settings(pkg, tmp):
    parse = _mod(pkg, 'gui.settings').parse_int_settings
    return [parse({'threads': '8', 'errors': '2'}),
            parse({'threads': '8', 'errors': 'x'})]


def _extents(pkg, tmp):
    resolve = _mod(pkg, 'gui.util').resolve_extent
    return [resolve(*a) for a in ((300, 1000, 200, 900),
                                  (-200, 1000, 200, 900),
                                  (0.5, 1000, 200, 900),
                                  (5000, 1000, 200, 900))]


def _explorer(pkg, tmp):
    ex = _mod(pkg, 'gui.explorer')
    analyse = _mod(pkg, 'analyse')
    os.makedirs(tmp)
    first = ex.unique_csv_name(tmp)
    open(first, 'w').close()
    return [sorted(['x10', 'x2', 'x1', 'y1.5', 'Y1'], key=ex.human_sort_key),
            ex.summary_line('phylo', 'lineage 3'),
            ex.summary_line('r', ['a', 'b']),
            [os.path.basename(p) for p in (first, ex.unique_csv_name(tmp))],
            ex.decoding_error_text(
                'f.json', analyse.TestsuiteVersionConflictException('boom')),
            ex.decoding_error_text(
                'g.json', analyse.VersionConflictException('old'))]


def _coverage_rows(pkg, tmp):
    ex = _mod(pkg, 'gui.explorer')
    genes = _mod(pkg, 'genes')
    analyse = _mod(pkg, 'analyse')
    genome = genes.Genome(os.path.join(HERE, 'test_genes.bases'),
                          identifier='toy')
    snp = genes.SNP(genome=genome, pos=100, orig=genome.read(100, 1),
                    base={'A': 'G'}.get(genome.read(100, 1), 'A'))
    test = genes.Test(snp, genes.Genotype('t'), genes.Reference('r'))
    coverage = analyse.Coverage(snp.seq(spacing=5))
    rows = [ex.coverage_markers(test, coverage),
            ex.format_coverage_row(test, coverage, None, [])]
    coverage.coverage = [10] * len(coverage.coverage)
    rows += [ex.coverage_markers(test, coverage),
             ex.format_coverage_row(test, coverage, [3, 4], [0, 1])]
    coverage.mutations = {5: 'AAAAAAA'}
    rows += [ex.coverage_markers(test, coverage),
             ex.format_coverage_row(test, coverage, [3, 4], [1, 0])]
    return rows


HELPERS = {'pair_fastqs': _pairs, 'histogram_bins': _bins,
           'split_log_line': _log_lines, 'parse_int_settings': _int_settings,
           'resolve_extent': _extents, 'explorer_helpers': _explorer,
           'coverage_rows': _coverage_rows}


@pytest.mark.parametrize('name', sorted(HELPERS))
def test_helpers_match_kvarq_tpu(name, tmp_path):
    want, got = (HELPERS[name](pkg, str(tmp_path / pkg)) for pkg in PKGS)
    assert got == want


def test_pair_fastqs_is_the_cli_copy():
    from kvarq_tpu_torch import cli
    from kvarq_tpu_torch.gui import simple
    assert simple.pair_fastqs is cli.pair_fastqs


# --- headless windows -------------------------------------------------------

def _settings_flow(pkg):
    default_config = _mod(pkg, 'config').default_config
    with headless(pkg):
        Settings = _mod(pkg, 'gui.settings').Settings
        config = dict(default_config)
        settings = Settings(config)
        settings.show()
        names = sorted(settings.entries)
        settings.entries['threads'].delete(0, 'end')
        settings.entries['threads'].insert(0, '3')
        settings.save_cb()
        saved = (dict(config), settings.win.destroyed)
        settings.show()
        settings.entries['errors'].delete(0, 'end')
        settings.entries['errors'].insert(0, 'bogus')
        settings.save_cb()
        refused = (faketk.messagebox.calls[-1][:2], dict(config))
        settings.cancel_cb()
        return names, saved, refused, settings.win.destroyed


def test_headless_settings_dialog():
    want, got = (_settings_flow(pkg) for pkg in PKGS)
    assert got == want
    names, (config, destroyed), (call, after), closed = got
    assert config['threads'] == 3 and destroyed and closed
    assert call[0] == 'showerror' and after == config


def _registry(pkg):
    return _mod(pkg, 'testsuites').discover_testsuites([TESTSUITES])


def _main_window_flow(pkg):
    with headless(pkg), logger_level(pkg, logging.INFO) as lo:
        gui = _mod(pkg, 'gui.main').MainGUI(testsuite_paths=_registry(pkg))
        try:
            lo.info('hello from the test')
            lo.warning('and a warning')
            lo.debug('not shown at INFO')
            logged = gui.text.get()
            labels = [w.cget('text') for w in faketk.Widget.ALL
                      if isinstance(w, faketk.Button)]
            next(w for w in faketk.Widget.ALL if isinstance(w, faketk.Button)
                 and w.cget('text') == 'settings').invoke()
            opened = not gui.settings.win.destroyed
            gui.settings.cancel_cb()
            with pytest.raises(SystemExit):
                gui.invoke_protocol('WM_DELETE_WINDOW')
            return (logged.split('GUI started\n')[-1], labels, opened,
                    faketk.messagebox.calls[-1][0])
        finally:
            lo.removeHandler(gui.log_handler)
            gui.destroy()


def test_headless_main_window():
    ''' the log pane of the port's window follows the port's logger
        (``kvarq_tpu_torch``), set to INFO here and put back after '''
    want, got = (_main_window_flow(pkg) for pkg in PKGS)
    assert got == want
    logged, labels, opened, asked = got
    assert logged == '[INFO] hello from the test\n[WARNING] and a warning\n'
    assert 'scan .fastq files' in labels and 'explore .json files' in labels
    assert opened and asked == 'askyesno'


def test_main_window_follows_the_port_logger():
    from kvarq_tpu.log import lo as jlo
    with headless('kvarq_tpu_torch'), \
            logger_level('kvarq_tpu_torch', logging.INFO) as lo:
        from kvarq_tpu_torch.gui.main import MainGUI
        gui = MainGUI(testsuite_paths=_registry('kvarq_tpu_torch'))
        try:
            jlo.warning('from kvarq_tpu')
            lo.warning('from the port')
            logged = gui.text.get()
        finally:
            lo.removeHandler(gui.log_handler)
            gui.destroy()
    assert 'from the port' in logged and 'from kvarq_tpu' not in logged


def test_tkplot_draws_all_zero_data():
    ''' kvarq_tpu's yticks divides by max(data): ZeroDivisionError on
        all-zero data; the port's draws no tick.  On other data both draw
        the same items. '''
    drawn = {}
    for pkg in PKGS:
        with headless(pkg):
            tkplot = _mod(pkg, 'gui.tkplot')
            win = faketk.Tk()
            for data in ([0, 0, 0], []):
                plot = tkplot.ReadlengthDisplay(win, data)
                if pkg == 'kvarq_tpu':
                    with pytest.raises((ZeroDivisionError, ValueError)):
                        plot.yticks([5])
                else:
                    plot.yticks([5])
                    assert plot.canvas.items == []
            plot = tkplot.ReadlengthDisplay(win, [0, 3, 9, 4])
            plot.update()
            plot.yticks([9, 4])
            drawn[pkg] = plot.canvas.items
    assert drawn['kvarq_tpu_torch'] == drawn['kvarq_tpu']


# --- scans ------------------------------------------------------------------

def _pump_until_done(gui, limit=300):
    deadline = time.time() + limit
    while gui.worker is not None and time.time() < deadline:
        faketk.pump(rounds=1)
        time.sleep(0.001)
    assert gui.worker is None, 'scan did not finish'


def _gui_scan(fastq, suites, more=(), **settings):
    ''' the port's SimpleGUI over ``fastq`` (and the files ``more`` queued
        after it) with ``suites`` ticked and the scan started; ``settings``
        override the defaults of the settings dialog '''
    from kvarq_tpu_torch.config import default_config
    from kvarq_tpu_torch.gui.settings import Settings
    from kvarq_tpu_torch.gui.simple import SimpleGUI
    faketk.filedialog.askopenfilename = lambda *a, **kw: (fastq, *more)
    gui = SimpleGUI(Settings(dict(default_config, **settings)), testsuites={},
                    testsuite_paths=_registry('kvarq_tpu_torch'))
    assert gui.fastqs == [fastq, *more]
    for button in gui.selector.buttons:
        if button.cget('text') in suites:
            button.invoke()
    gui.start.invoke()
    assert gui.running
    return gui


def _save(gui, path):
    fd = open(path, 'w')
    faketk.filedialog.asksaveasfile = lambda *a, **kw: fd
    gui.save_cb()
    fd.close()
    with open(path) as f:
        return json.load(f)


def _kvarq_tpu_scan(fastq, suite):
    ''' kvarq_tpu's ``Analyser().scan(...).encode()`` of ``fastq`` under
        the GUI's default settings, read with one thread (kvarq_tpu's
        threaded reader can lose the wake-up at the end of input) '''
    from kvarq_tpu import analyse, engine
    from kvarq_tpu.config import config_params, default_config
    from kvarq_tpu.fastq import Fastq
    from kvarq_tpu.testsuites import load_testsuites
    fq = Fastq(fastq)
    engine.config(**dict(config_params(dict(default_config), fq),
                         nthreads=1))
    suites = load_testsuites(_registry('kvarq_tpu'), [suite])
    analyser = analyse.Analyser()
    analyser.scan(fq, suites)
    analyser.update_testsuites()
    return json.loads(json.dumps(analyser.encode()))   # as saved


@needs_genome
def test_headless_scan_save_explore(tmp_path):
    ''' pick the MTBC fixture, tick MTBC/phylo, scan on the worker thread
        (the port's engine on the CPU) with the timer poll loop, save,
        then explore the result (listings, plot windows, directory
        explorer, csv summary) '''
    with headless('kvarq_tpu_torch'), \
            logger_level('kvarq_tpu_torch', logging.WARNING):
        from kvarq_tpu_torch.gui.explorer import (DirectoryExplorer,
                                                  JsonExplorer)
        gui = _gui_scan(MTBC_FASTQ, ['MTBC/phylo'])
        _pump_until_done(gui)
        assert gui.show.cget('state') == 'normal'
        analyser = gui.analysers[MTBC_FASTQ]
        assert analyser.hits is not None      # Analyser.scan's hit path
        jpath = tmp_path / 'result.json'
        data = _save(gui, jpath)
        want = _kvarq_tpu_scan(MTBC_FASTQ, 'MTBC/phylo')
        for key in ('coverages', 'analyses', 'stats'):
            assert data[key] == want[key], key
        assert data['info']['format'] == 'kvarq'

        gui.show_cb()
        explorer = JsonExplorer(str(jpath), testsuites={},
                                testsuite_paths=_registry('kvarq_tpu_torch'))
        assert any('MTBC/phylo' in item for item in explorer.alist.items)
        faketk.pump(rounds=5)
        explorer.alist.selection_set(0)
        faketk.pump(rounds=5)
        assert any(line.startswith('fastq :')
                   for line in explorer.clist.items)
        for row, line in enumerate(explorer.clist.items):
            if line.endswith('...'):
                explorer.clist.selection_set(row)
                explorer.show_coverage(None)
        explorer.alist.selection_set(1)
        explorer.refresh_coverages()
        assert len(explorer.clist.items) \
            == len(analyser.testsuites['MTBC/phylo'].tests)
        explorer.clist.selection_set(0)
        explorer.show_coverage(None)
        canvases = [w for w in faketk.Widget.ALL
                    if isinstance(w, faketk.Canvas)]
        for canvas in canvases:
            canvas.event_generate('<Configure>')
        assert any(canvas.items for canvas in canvases)

        dx = DirectoryExplorer(str(tmp_path), testsuites={},
                               testsuite_paths=_registry('kvarq_tpu_torch'))
        assert dx.jlist.items == ['result.json']
        dx.jlist.selection_set(0)
        dx.open_json()
        dx.summarize()

        def exported():
            return any(c[0] == 'showinfo' and 'csv' in str(c[1]) + str(c[2])
                       for c in faketk.messagebox.calls)
        faketk.pump(rounds=100000, until=exported)
        assert exported()
        assert not [c for c in faketk.messagebox.calls if c[0] == 'showerror']
        csvs = list(tmp_path.glob('results*.csv'))
        assert csvs and 'MTBC/phylo' in csvs[0].read_text()


@needs_genome
@pytest.mark.parametrize('when', ['at first progress', 'before the scan',
                                  'two files queued'])
def test_stopped_scan_returns_partial_results(when, tmp_path):
    ''' "stop" at the first poll that shows the scan's parsed records, or
        before the engine's scan has begun (kvarq_tpu loses that stop: the
        scan resets the flag when it begins): the scan ends mid-file, and the
        saved analyses are those of its coverages (kvarq_tpu's decode and
        update_testsuites of the saved json).  With a second file queued,
        "start next" stays disabled until the stopped scan's results are
        recorded under its own file (kvarq_tpu moves on at the click and
        records them under the next file), and the next file then scans
        in full.  One reader thread (the settings' "threads"): with more,
        the reader parses this small file ahead in one go. '''
    from kvarq_tpu import analyse as janalyse
    from kvarq_tpu.testsuites import load_testsuites
    from kvarq_tpu_torch import bench, engine
    suites = load_testsuites(_registry('kvarq_tpu'), ['MTBC/phylo'])
    fastq = str(tmp_path / 'corpus.fastq')
    second = str(tmp_path / 'second.fastq')
    n_reads, n_second = 40000, 2000
    queued = (second,) if when == 'two files queued' else ()
    engine.config(sieve='off', batchsize=512)
    with headless('kvarq_tpu_torch'), \
            logger_level('kvarq_tpu_torch', logging.WARNING):
        windows = bench.template_windows({k: v for k, v in
                                          bench.load_mtbc().items()
                                          if k == 'MTBC/phylo'})
        bench.generate_fastq(fastq, windows, n_reads, 101, plant=0.2)
        if queued:
            bench.generate_fastq(second, windows, n_second, 101, seed=7,
                                 plant=0.2)
        gui = _gui_scan(fastq, ['MTBC/phylo'], more=queued, threads=1)
        worker = gui.worker
        # records_parsed: the reader raises ``parsed`` (and with it the
        # progress) before it has parsed a whole record
        deadline = time.time() + 60
        while when != 'before the scan' and not (
                engine._running and engine.stats()['records_parsed'] > 0):
            assert time.time() < deadline and worker.is_alive(), \
                'no parsed records seen while the scan ran'
            faketk.pump(rounds=1)
            time.sleep(0.001)
        gui.start.invoke()                    # "stop"
        assert not gui.running
        assert gui.start.cget('state') == 'disabled' and gui.fastqi == 0
        _pump_until_done(gui)                 # stop, wait, analyse
        assert not worker.is_alive()
        assert worker.stopped and worker.finished
        assert list(gui.analysers) == [fastq]
        analyser = gui.analysers[fastq]
        if queued:
            assert gui.start.cget('state') == 'normal'
            assert gui.start.cget('text') == 'start next'
            gui.start.invoke()                # "start next"
            assert gui.running and gui.worker is not worker
            _pump_until_done(gui)
            assert list(gui.analysers) == [fastq, second]
            assert gui.analysers[second].stats['records_parsed'] == n_second
            outdir = tmp_path / 'saved'
            outdir.mkdir()
            faketk.filedialog.askdirectory = lambda *a, **kw: str(outdir)
            gui.save_cb()                     # "save all"
            with open(outdir / 'corpus.json') as f:
                data = json.load(f)
        else:
            data = _save(gui, tmp_path / 'stopped.json')
    stats = analyser.stats
    assert stats['records_parsed'] < n_reads
    if when != 'before the scan':
        assert stats['records_parsed'] > 0
    assert data['stats']['records_parsed'] == stats['records_parsed']
    assert list(data['analyses']) == ['MTBC/phylo']
    ref = janalyse.Analyser()
    ref.decode(suites, data)
    ref.update_testsuites()
    assert ref.encode()['analyses'] == data['analyses']


def test_scan_without_a_card_fails(monkeypatch):
    ''' a GUI scan runs on the engine's device, the card by default: with
        no card the worker fails and the error dialog opens; nothing falls
        back to the CPU '''
    from kvarq_tpu_torch import engine
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    engine.config(device='cuda')
    with headless('kvarq_tpu_torch'), \
            logger_level('kvarq_tpu_torch', logging.CRITICAL):
        gui = _gui_scan(MTBC_FASTQ, ['MTBC/spoligo'])
        _pump_until_done(gui)
        assert not gui.analysers
        kind, (title, text), _ = faketk.messagebox.calls[-1]
        assert (kind, title) == ('showerror', 'could not scan')
        assert 'torch.cuda.is_available() is False' in text
        assert "CUDA toolkit's nvcc" in text


# --- the CLI commands -------------------------------------------------------

@needs_genome
def test_cli_gui_and_explorer(tmp_path, capsys):
    ''' ``gui`` and ``explorer`` open the port's windows (no "not yet
        ported"); the explorer takes a result json or a directory '''
    from kvarq_tpu_torch import cli
    jpath = tmp_path / 'r.json'
    cli.main(['-q', '-t', TESTSUITES, 'scan', '-f', '-l', 'MTBC/spoligo',
              '--backend', 'cpu', MTBC_FASTQ, str(jpath)])
    with headless('kvarq_tpu_torch') as tk, \
            logger_level('kvarq_tpu_torch', logging.WARNING):
        tk.mainloop = lambda n=0: faketk.pump(rounds=20)
        cli.main(['-t', TESTSUITES, 'gui'])
        cli.main(['-t', TESTSUITES, 'explorer', str(jpath)])
        cli.main(['-t', TESTSUITES, 'explorer', str(tmp_path)])
        titles = [w.wm_title() for w in faketk.Widget.ALL
                  if isinstance(w, faketk.Tk)]
    from kvarq_tpu_torch import VERSION
    assert 'not yet ported' not in capsys.readouterr().err
    assert 'KvarQ-TPU ' + VERSION in titles               # the launcher
    assert any(t.endswith(' -- json explorer') for t in titles)
    assert any(t.endswith(' -- explore .json files') for t in titles)
