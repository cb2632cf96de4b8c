'''
Scan wizard: pick ``.fastq`` files (with automatic ``_1``/``_2`` pair
merging), tick testsuites, scan each file on a worker thread with a live
progress readout, then show the results in the explorer or save them as
``.json`` files.

The scan runs on the port's engine, on its configured device: the card
(``cuda``, the engine's default) unless a caller has set
``engine.config(device='cpu')``, and through the engine's ``backend``
key (the numpy matcher on the host with ``numpy``); with no card, or no
``nvcc`` to build the kernel, it fails with an error dialog that names
both.  ``pair_fastqs`` is the CLI's (``batch`` needs it on hosts
without tkinter).
'''

import json
import os
import threading
import time
import tkinter as tk
import tkinter.filedialog as tkfiledialog
import tkinter.messagebox as tkmessagebox

from kvarq_tpu_torch import analyse, engine
from kvarq_tpu_torch.cli import pair_fastqs
from kvarq_tpu_torch.config import config_params
from kvarq_tpu_torch.fastq import Fastq, FastqFileFormatException
from kvarq_tpu_torch.gui.explorer import JsonExplorer
from kvarq_tpu_torch.gui.util import ThemedTk, askopenfilename
from kvarq_tpu_torch.log import lo, tic, toc
from kvarq_tpu_torch.testsuites import load_testsuites
from kvarq_tpu_torch.util import ProgressBar


# what a scan on the card needs, named in the "could not scan" dialog
CARD_NEEDS = ('\n\n(a scan on the card needs a CUDA card and the CUDA '
              'toolkit\'s nvcc, which builds the port\'s kernel at its '
              'first use)')


def unique_json_path(directory, fastq_name):
    ''' a non-existing ``.json`` path for a scanned fastq '''
    base = os.path.splitext(os.path.basename(fastq_name))[0]
    while True:
        path = os.path.join(directory, base + '.json')
        if not os.path.exists(path):
            return path
        base += '_'


class ScanWorker(threading.Thread):

    ''' runs ``Analyser.scan`` off the GUI thread '''

    def __init__(self, analyser, fastq, testsuites):
        super().__init__(name='analyse-thread')
        self.analyser = analyser
        self.fastq = fastq
        self.testsuites = testsuites
        self.finished = False
        self.exception = None
        self.stopped = False

    def run(self):
        try:
            self.analyser.scan(self.fastq, self.testsuites)
            self.finished = True
        except Exception as e:
            self.exception = e

    def stop(self):
        engine.stop()
        self.stopped = True


class TestsuiteSelector(ThemedTk):

    ''' checkbox list of all discovered testsuites '''

    def __init__(self, testsuite_paths):
        ThemedTk.__init__(self)
        tk.Label(self, text='select testsuites for scan:').pack(anchor='w')

        self.values = dict.fromkeys(testsuite_paths, False)
        self.buttons = []
        for name in sorted(testsuite_paths):
            button = tk.Checkbutton(self, text=name,
                                    command=self._toggler(name))
            button.pack(anchor='w')
            self.buttons.append(button)

        self.disabled = False
        self.closed = False
        self.protocol('WM_DELETE_WINDOW', self.closing)

    def _toggler(self, name):
        def toggle(_=None):
            self.values[name] = not self.values[name]
        return toggle

    def closing(self, _=None):
        self.closed = True
        self.destroy()

    def selection(self):
        return [name for name, on in self.values.items() if on]

    def disable(self):
        if not self.closed:
            for button in self.buttons:
                button.config(state='disabled')
        self.disabled = True


class SimpleGUI(ThemedTk):

    POLL_MS = 100

    def __init__(self, settings, testsuites, testsuite_paths):
        self.settings = settings
        self.testsuites = testsuites          # cache of loaded testsuites
        self.testsuite_paths = testsuite_paths

        self.fastqi = -1
        self.analysers = {}
        self.fastqs, self.paireds = self.askfastqs()
        if self.fastqs is not None:
            self._build_window()
            self.next_fastq()

    # --- window ----------------------------------------------------------

    def _build_window(self):
        ThemedTk.__init__(self, title='scan .fastq files')
        self.bind('<Destroy>', self.destroy_cb)

        self.selector = TestsuiteSelector(self.testsuite_paths)
        self.selected_testsuites = {}
        self.analyser = None
        self.worker = None
        self.running = False
        self.save_hits = False

        top = tk.Frame(self)
        self.fname = tk.Label(top)
        self.fname.pack(side=tk.LEFT)
        top.pack(side=tk.TOP, expand=False, fill=tk.X)

        middle = tk.Frame(self)
        self.start = tk.Button(middle, text='start',
                               command=self.startstop, state=tk.DISABLED)
        self.start.pack(side=tk.LEFT)
        self.pb = ProgressBar(total=1., r='')
        self.pb_longest = 0
        self.pblabel = tk.Label(middle, text=' ' * 70, font=self.monospace)
        self.pblabel.pack(side=tk.LEFT)
        middle.pack(side=tk.TOP, expand=False, fill=tk.X)

        bottom = tk.Frame(self)
        self.show = tk.Button(bottom, text='show', command=self.show_cb,
                              state=tk.DISABLED)
        self.show.pack(side=tk.LEFT)
        self.save = tk.Button(bottom, text='save', command=self.save_cb,
                              state=tk.DISABLED)
        self.save.pack(side=tk.LEFT)
        bottom.pack(side=tk.TOP, expand=False, fill=tk.X)

        if len(self.fastqs) > 1:
            self.show.config(text='show last')
            self.save.config(text='save all')

        self.resizable(0, 0)
        self.protocol('WM_DELETE_WINDOW', self.closing)

    def closing(self, _=None):
        if not self.selector.closed:
            self.selector.destroy()
        self.destroy()

    def destroy_cb(self, _=None):
        if self.running:
            self.worker.stop()
            self.worker.join()

    # --- file iteration -----------------------------------------------------

    def askfastqs(self):
        ''' :returns: ``(files, paired_flags)`` or ``(None, None)`` when
            the dialog was canceled '''
        picked = askopenfilename(
            initialdir=os.getcwd(), multiple=True,
            filetypes=[('fastq files', '*.fastq'),
                       ('compressed fastq files', '*.fastq.gz')],
            title='select .fastq files to analyze')
        if not picked:
            return None, None
        return pair_fastqs(picked)

    def has_more_fastq(self):
        return self.fastqi + 1 < len(self.fastqs)

    def next_fastq(self):
        ''' advance to the next loadable file; :returns: success '''
        total = len(self.fastqs)
        while True:
            self.fastqi += 1
            if self.fastqi >= total:
                return False
            try:
                self.fastq = Fastq(self.fastqs[self.fastqi],
                                   paired=self.paireds[self.fastqi])
            except FastqFileFormatException as e:
                lo.error('cannot load file %s : %s'
                         % (self.fastqs[self.fastqi], e))
                if total == 1:
                    tkmessagebox.showerror(
                        'invalid .fastq file',
                        'the selected file cannot be parsed : ' + str(e))
                continue

            label = self.fastq.fname
            if total > 1:
                label += ' (file %d/%d)' % (self.fastqi + 1, total)
            self.fname.config(text=label)
            self.start.config(state=tk.NORMAL)
            return True

    # --- scanning ------------------------------------------------------------

    def _ensure_selection(self):
        ''' resolve the selector checkboxes into loaded testsuites;
            :returns: False when nothing is selected '''
        if self.selected_testsuites:
            return True
        selection = self.selector.selection()
        if not selection:
            tkmessagebox.showerror(
                'no testsuite selected',
                'please select at least one testsuite before scanning')
            if self.selector.closed:
                self.selector = TestsuiteSelector(self.testsuite_paths)
            return False
        missing = set(selection) - set(self.testsuites.keys())
        self.selector.disable()
        self.testsuites.update(
            load_testsuites(self.testsuite_paths, missing))
        self.selected_testsuites = {name: self.testsuites[name]
                                    for name in selection}
        return True

    def startstop(self):
        if not self._ensure_selection():
            return

        if self.running:
            # "stop" clicked: poll() notices, wraps up partial results and
            # then offers the next file; until then nothing can start a
            # second scan beside the stopping one
            self.start.config(state=tk.DISABLED)
            self.running = False
            return

        self.analyser = analyse.Analyser()
        engine.config(**config_params(self.settings.config, self.fastq))
        self.worker = ScanWorker(self.analyser, self.fastq,
                                 self.selected_testsuites)
        self.t0 = time.time()
        self.worker.start()
        self.pb.start()
        self.after(self.POLL_MS, self.poll)
        lo.info('start scanning %s (%d MB)'
                % (self.fastq.fname,
                   os.path.getsize(self.fastq.fname) // 1024 ** 2))
        self.running = True
        self.start.config(text='stop')

    def _show_progress(self):
        self.pb.update(engine.stats()['progress'])
        text = str(self.pb)
        self.pb_longest = max(self.pb_longest, len(text))
        self.pblabel.config(text=text.ljust(self.pb_longest))

    def finish_scanning(self):
        lo.info('analyzing data...')
        self.analyser.update_testsuites()
        lo.info('done analyzing data')
        self.analysers[self.fastqs[self.fastqi]] = self.analyser
        self.show.config(state=tk.NORMAL)
        self.save.config(state=tk.NORMAL)

    def poll(self):
        if not self.running:
            # "stop" was clicked: the scan ends at its next batch.  Stop
            # again at every poll (a stop that comes before the engine's
            # scan has begun is reset when it begins), compute results
            # once the worker has returned and record them under the
            # stopped file, then move on; kvarq_tpu analyses at once,
            # racing the worker that still fills the coverages, and has
            # already moved to the next file
            self.worker.stop()
            if self.worker.is_alive():
                self.after(self.POLL_MS, self.poll)
                return
            lo.info('STOPPED scanning via GUI after %.3f seconds'
                    % (time.time() - self.t0))
            self.finish_scanning()
            self.worker = None
            if self.next_fastq():
                self.start.config(text='start next')
            return

        self._show_progress()

        if not (self.worker.finished or self.worker.exception):
            self.after(self.POLL_MS, self.poll)
            return

        # worker done (or died)
        self.worker.join()
        self.start.config(state=tk.DISABLED)
        if self.worker.finished:
            lo.info('finished scanning after %.3f seconds'
                    % (time.time() - self.t0))
            text = str(self.pb)
            self.pblabel.config(text=text[:text.index(']') + 1] + ' -- done')
            self.finish_scanning()
        if self.worker.exception:
            lo.error('could not scan %s : %s'
                     % (self.fastq.fname, self.worker.exception))
            tkmessagebox.showerror(
                'could not scan',
                'the scanning of the file "%s" could not be completed : %s%s'
                % (self.fastq.fname, self.worker.exception, CARD_NEEDS
                   if str(engine._extra_config['device']).startswith('cuda')
                   and engine._extra_config['backend'] != 'numpy' else ''))
        self.running = False
        self.worker = None
        if self.next_fastq():
            self.startstop()

    # --- results -----------------------------------------------------------

    def show_cb(self):
        if self.analyser.results is None:
            tkmessagebox.showinfo('no results yet',
                                  'please stop/finish the scanning first')
            return
        JsonExplorer(self.analyser, testsuites=self.testsuites,
                     testsuite_paths=self.testsuite_paths)

    def _save_one(self, analyser, fd):
        tic('dumping json')
        json.dump(analyser.encode(hits=self.save_hits), fd, indent=2)
        toc('dumping json')

    def save_cb(self):
        if len(self.analysers) == 1:
            fd = tkfiledialog.asksaveasfile(
                parent=self,
                initialfile=os.path.splitext(os.path.basename(
                    self.fastq.fname))[0] + '.json',
                initialdir=os.path.dirname(self.fastq.fname),
                defaultextension='.json',
                title='select .json to store results of scan')
            if fd:
                self._save_one(self.analyser, fd)
            return

        directory = tkfiledialog.askdirectory(
            parent=self, title='select directory to store .json files')
        if not directory:
            return
        for fastq, analyser in self.analysers.items():
            path = unique_json_path(directory, fastq)
            lo.info('saving to ' + path)
            with open(path, 'w') as fd:
                self._save_one(analyser, fd)
