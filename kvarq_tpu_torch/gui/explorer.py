'''
Result explorers: :py:class:`DirectoryExplorer` lists many result ``.json``
files (with background csv summarizing), :py:class:`JsonExplorer` shows a
single result -- testsuite outcomes on top, info/statistics + per-test
coverages below, double-click opens the matching plot window.

The listing *content* (info lines, per-test rows with ``~`` mixed / ``+``
validated markers) is produced by pure functions at the top of the module
so it can be unit-tested without a display.
'''

import glob
import json
import os
import re
import sys
import tkinter as tk
import tkinter.messagebox as tkmessagebox

from kvarq_tpu_torch import DOWNLOAD_URL
from kvarq_tpu_torch.analyse import (Analyser, DecodingException,
                                     TestsuiteVersionConflictException,
                                     VersionConflictException)
from kvarq_tpu_torch.genes import SNP, TemplateFromGenome
from kvarq_tpu_torch.gui.tkplot import (CoverageWindow, HitHistogramWindow,
                                        MeanCoverageWindow, ReadlengthWindow,
                                        SpoligoWindow)
from kvarq_tpu_torch.gui.util import (BackgroundJob, ThemedTk,
                                      askopenfilename, open_help, scrolled)
from kvarq_tpu_torch.log import lo
from kvarq_tpu_torch.testsuites import update_testsuites
from kvarq_tpu_torch.util import JsonSummary


# --- pure listing/formatting helpers (unit-testable) -------------------------

def human_sort_key(key):
    ''' natural ordering: digit groups compare numerically, text groups
        case-insensitively '''
    parts = re.split(r'(\d*\.\d+|\d+)', str(key))
    return tuple(part.swapcase() if i % 2 == 0 else float(part)
                 for i, part in enumerate(parts))


def coverage_markers(test, coverage):
    ''' the ``~`` (mixed) / ``+`` (validated, one per region mutation)
        prefix of an explorer coverage row '''
    sign = '~' if coverage.mixed() else ''
    template = test.template
    if isinstance(template, TemplateFromGenome) \
            and not isinstance(template, SNP):
        sign += '+' * len(template.mutations(coverage))
    elif template.validate(coverage):
        sign += '+'
    return sign


def format_coverage_row(test, coverage, nseqhits, indexes):
    ''' one line of the explorer coverage list '''
    hits = ''
    if nseqhits is not None:
        hits = '%d hits ' % sum(nseqhits[i] for i in indexes)
    return '%s %s %s(mean %.1f/%.1f)' % (
        coverage_markers(test, coverage), test, hits,
        coverage.seqmean(), coverage.mean(include_margins=False))


def info_lines(analyser):
    ''' the "info" listing: fastq metadata, engine config, then the
        clickable plot entries and live stats '''
    return [
        'fastq : ' + ', '.join(analyser.fastq_filenames),
        'size : ' + ', '.join('%.2f MB' % (s / 1024. ** 2)
                              for s in analyser.fastq_sizes),
        'readlength : %d' % analyser.fastq_readlength,
        'records_approx : %s' % str(analyser.fastq_records_approx or '?'),
        'scantime : %d s' % int(analyser.scantime),
        'config : ' + ' '.join('%s=%s' % item
                               for item in analyser.config.items()),
        '',
        'readlengths...',
        'mean coverage...',
        'hits/template...',
        'records_parsed : %d' % analyser.stats.get('records_parsed', -1),
        'progress : %.1f %%' % (float(analyser.stats['progress']) * 100),
    ]


def summary_line(name, result):
    ''' one line of the analyses list '''
    if isinstance(result, list):
        result = '; '.join(result)
    return name + ': ' + str(result)


def decoding_error_text(jpath, exception):
    ''' user-facing message for a result file that cannot be loaded '''
    hint = ''
    if isinstance(exception, TestsuiteVersionConflictException):
        hint = ('\n\nYou must load compatible versions of testsuites when '
                'exploring a .json file; or find old versions online at '
                + DOWNLOAD_URL)
    elif isinstance(exception, VersionConflictException):
        hint = ('\n\nSome old versions used a file format that cannot be '
                'parsed with this version; older releases are available '
                'at ' + DOWNLOAD_URL)
    return 'cannot load file %s : %s%s' % (jpath, exception, hint)


def unique_csv_name(dname):
    ''' first free results[N].csv path inside ``dname`` '''
    fname = os.path.join(dname, 'results.csv')
    n = 2
    while os.path.exists(fname):
        fname = os.path.join(dname, 'results%d.csv' % n)
        n += 1
    return fname


# --- directory browser --------------------------------------------------------

class DirectoryExplorer:

    def __init__(self, dname, testsuites, testsuite_paths):
        self.testsuites = testsuites
        self.testsuite_paths = testsuite_paths

        if dname:
            self.dname = os.path.abspath(dname)
            self.jpaths = glob.glob(os.path.join(self.dname, '*.json'))
        else:
            picked = askopenfilename(
                initialdir=os.getcwd(),
                title='Choose .json files to explore',
                multiple=True, filetypes=[('json files', '*.json')])
            if not picked:
                return
            if len(picked) == 1:
                self.do_open_json(picked[0])
                return
            self.jpaths = [os.path.abspath(p) for p in picked]
            self.dname = os.path.dirname(self.jpaths[0])

        self._build_window()
        self.refresh()
        self.jlist.activate(0)
        self.jlist.selection_set(0)
        self.jlist.focus_set()

    def _build_window(self):
        self.win = ThemedTk(title='explore .json files', esc_closes=True,
                            geometry=(400, 800))
        self.win.columnconfigure(0, weight=1)
        self.win.columnconfigure(1, weight=0)
        self.win.rowconfigure(1, weight=1)

        self.dlabel = tk.Label(self.win, text='(no directory chosen)')
        self.dlabel.grid(row=0, column=0, columnspan=2, sticky='ew')

        frame, self.jlist = scrolled(tk.Listbox, self.win)
        frame.grid(row=1, column=0, columnspan=2, sticky='nsew')
        self.jlist.bind('<Double-Button-1>', self.open_json)
        self.jlist.bind('<Return>', self.open_json)

        self.convert = tk.Button(self.win, text='summarize...',
                                 command=self.summarize)
        self.convert.grid(row=2, column=0, sticky='ew')

    def refresh(self):
        shown = self.dname
        if len(shown) > 30:
            shown = '...' + shown[-27:]
        self.dlabel.config(text=shown)
        self.jlist.delete(0, tk.END)
        for jpath in self.jpaths:
            self.jlist.insert(tk.END, os.path.basename(jpath))

    # reference-compatible alias
    update = refresh

    def open_json(self, _=None):
        idxs = self.jlist.curselection()
        if not idxs:
            lo.warning('cannot open JsonExplorer : idxs=' + str(idxs))
            return
        self.do_open_json(self.jpaths[int(idxs[0])])

    def do_open_json(self, jpath):
        try:
            JsonExplorer(jpath, self.testsuites, self.testsuite_paths)
        except DecodingException as e:
            tkmessagebox.showerror('file format error',
                                   decoding_error_text(jpath, e))

    def summarize(self, _=None):
        ''' csv-summarize all listed jsons on a background thread '''
        fname = unique_csv_name(self.dname)
        job = BackgroundJob('exporting data...')
        self.convert.config(state='disabled')
        original_text = self.convert.config('text')[4]
        progress = dict(n=0)

        def do_export():
            summary = JsonSummary()
            for jpath in self.jpaths:
                if job.canceled:
                    break
                job.message = 'extracting from ' + os.path.basename(jpath)
                try:
                    summary.add(jpath)
                    progress['n'] += 1
                except Exception as e:
                    lo.error('could not load %s : %s' % (jpath, e))
            try:
                with open(fname, 'w') as fd:
                    summary.dump(fd)
            except IOError as e:
                lo.error('could not write to file %s : %s' % (fname, e))

        def export_done():
            self.convert.config(state='normal', text=original_text)
            tkmessagebox.showinfo(
                title='created .csv',
                message='successfully extracted informations from %d '
                        '.jsons and saved to %s' % (progress['n'], fname))

        job.start(do_export, export_done)


# --- single-result explorer ----------------------------------------------------

class JsonExplorer:

    POLL_MS = 250

    def __init__(self, jpath_or_analyser, testsuites, testsuite_paths):
        self.win = ThemedTk(title='json explorer', esc_closes=True,
                            geometry=(-200, -200))

        if isinstance(jpath_or_analyser, Analyser):
            self.analyser = jpath_or_analyser
            name = os.path.basename(self.analyser.fastq.fname)
        else:
            try:
                self.analyser = self._load(jpath_or_analyser, testsuites,
                                           testsuite_paths)
            except Exception:
                exc_info = sys.exc_info()
                self.win.destroy()
                raise exc_info[1].with_traceback(exc_info[2])
            name = os.path.basename(jpath_or_analyser)

        self._build_window(name)
        self.current = None
        self.alist.activate(0)
        self.alist.selection_set(0)
        self.alist.focus_set()
        self.after_id = None
        self.poll()

    @staticmethod
    def _load(jpath, testsuites, testsuite_paths):
        with open(jpath) as fd:
            data = json.load(fd)
        update_testsuites(testsuites, data['info']['testsuites'],
                          testsuite_paths)
        analyser = Analyser()
        analyser.decode(testsuites, data)
        analyser.update_testsuites()
        return analyser

    def _build_window(self, name):
        self.win.columnconfigure(0, weight=1)
        self.win.columnconfigure(1, weight=0)
        self.win.rowconfigure(2, weight=4)

        tk.Label(self.win, text=name).grid(row=0, column=0, columnspan=2,
                                           sticky='ew')

        menu = tk.Menu(self.win)
        filemenu = tk.Menu(menu)
        menu.add_cascade(label='KvarQ', menu=filemenu)
        filemenu.add_command(label='Help', command=open_help)
        self.win.config(menu=menu)

        # analyses (top)
        frame, self.alist = scrolled(
            tk.Listbox, self.win,
            height=len(self.analyser.testsuites) + 1)
        frame.grid(row=1, column=0, columnspan=2, sticky='nsew')
        self.alist.bind('<Double-Button-1>', self.show_analyses)
        self.alist.bind('<Return>', self.show_analyses)

        self.anames = ['info']
        self.alist.insert(tk.END, 'info')
        for aname in self.analyser.testsuites:
            self.anames.append(aname)
            self.alist.insert(tk.END, summary_line(
                aname, self.analyser.results[aname]))

        # coverages (bottom)
        frame, self.clist = scrolled(tk.Listbox, self.win)
        frame.grid(row=2, column=0, columnspan=2, sticky='nsew')
        self.clist.bind('<Double-Button-1>', self.show_coverage)
        self.clist.bind('<Return>', self.show_coverage)

        def close_win(_=None):
            if self.after_id:
                self.win.after_cancel(self.after_id)
            self.win.destroy()
        self.win.close = close_win
        self.win.protocol('WM_DELETE_WINDOW', close_win)

    # --- selections ------------------------------------------------------

    def show_analyses(self, _):
        idxs = self.alist.curselection()
        if not idxs:
            return
        aname = self.anames[int(idxs[0])]
        # testsuites exposing numbered spoligo genotypes get bar plots
        if aname.endswith('spoligo'):
            tests = self.analyser.testsuites[aname].tests
            spoligos = [-1] * len(tests)
            for test in tests:
                spoligos[test.genotype.number] = self.analyser[test].mean()
            SpoligoWindow(spoligos)

    def show_coverage(self, _):
        idxs = self.clist.curselection()
        if not idxs:
            return

        if self.aname == 'info':
            self._open_info_plot(self.infos[int(idxs[0])])
            return

        test = self.tests_sorted[int(idxs[0])]
        try:
            coverage = self.analyser[test]
        except KeyError:
            tkmessagebox.showinfo(
                title='test not found',
                message='"%s" not found in .json' % str(test))
            return
        CoverageWindow(test, coverage)

    def _open_info_plot(self, entry):
        analyser = self.analyser
        if entry == 'readlengths...':
            ReadlengthWindow(analyser.stats['readlengths'])
        elif entry == 'mean coverage...':
            MeanCoverageWindow([coverage.mean(include_margins=False)
                                for coverage in
                                analyser.coverages.values()])
        elif entry == 'hits/template...':
            nseqhits = analyser.stats['nseqhits']
            HitHistogramWindow([
                sum(nseqhits[i] for i in analyser.get_indexes(cname))
                for cname in analyser.coverages])

    # --- bottom list refresh ------------------------------------------------

    def refresh_coverages(self):
        idxs = self.alist.curselection()
        if not idxs:
            return
        self.aname = self.anames[int(idxs[0])]
        self.clist.delete(0, tk.END)

        if self.aname == 'info':
            self.infos = info_lines(self.analyser)
            for line in self.infos:
                self.clist.insert(tk.END, line)
            return

        tests = self.analyser.testsuites[self.aname].tests
        self.tests_sorted = sorted(tests, key=human_sort_key)
        nseqhits = self.analyser.stats.get('nseqhits')
        for test in self.tests_sorted:
            try:
                coverage = self.analyser[test]
            except KeyError:
                self.clist.insert(tk.END,
                                  '(test %s not found in .json)' % test)
                continue
            indexes = (self.analyser.get_indexes(test)
                       if nseqhits is not None else [])
            self.clist.insert(tk.END, format_coverage_row(
                test, coverage, nseqhits, indexes))

    # reference-compatible alias
    update = refresh_coverages

    def poll(self):
        now = self.alist.curselection()
        if now != self.current:
            self.refresh_coverages()
            self.current = now
        self.after_id = self.win.after(self.POLL_MS, self.poll)
