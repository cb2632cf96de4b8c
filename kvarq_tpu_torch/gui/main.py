'''
Launcher window: action buttons on the left, a live color-coded log pane
on the right (fed by a ``logging`` handler attached to the port's
``kvarq_tpu_torch`` logger).  Closing it exits the whole application after
confirmation.
'''

import logging
import sys
import tkinter as tk
import tkinter.font as tkfont
import tkinter.messagebox as tkmessagebox

from kvarq_tpu_torch.config import default_config
from kvarq_tpu_torch.gui.explorer import DirectoryExplorer
from kvarq_tpu_torch.gui.settings import Settings
from kvarq_tpu_torch.gui.simple import SimpleGUI
from kvarq_tpu_torch.gui.util import ThemedTk, open_help, scrolled
from kvarq_tpu_torch.log import lo, logfn


def split_log_line(line):
    ''' split a formatted ``[LEVEL] message`` line into its tag part and
        the rest (pure helper, unit-testable without a display) '''
    if line.startswith('[') and ']' in line:
        end = line.index(']') + 1
        return line[:end], line[end:]
    return '', line


class GuiLogHandler(logging.Handler):

    ''' appends kvarq log records to a (read-only) Text widget, coloring
        the level tag; message text is bold for warnings/errors '''

    #: level name -> (tag style for the '[LEVEL]' part, bold message)
    STYLES = {
        'DEBUG': ('debug', False),
        'INFO': ('info', False),
        'WARNING': ('alert', True),
        'ERROR': ('alert', True),
    }

    def __init__(self, text, scrollfn):
        super().__init__(level=logging.DEBUG)
        self.text = text
        self.scrollfn = scrollfn
        self.fmt = logging.Formatter('[%(levelname)s] %(message)s')

        bold = tkfont.Font(text, family='Courier New', size=13,
                           weight='bold')
        text.tag_config('debug', foreground='#888')
        text.tag_config('info', foreground='#080')
        text.tag_config('alert', background='red', foreground='white')
        text.tag_config('bold', font=bold)
        text.configure(state='disabled')

    def emit(self, record):
        try:
            self.text.insert('end', '')
        except Exception:
            return  # widget destroyed
        tag_style, bold = self.STYLES.get(record.levelname, (None, False))
        head, tail = split_log_line(self.fmt.format(record))
        self.text.config(state='normal')
        if tag_style == 'debug':
            self.text.insert('end', head + tail + '\n', ('debug',))
        else:
            if head:
                self.text.insert('end', head,
                                 (tag_style,) if tag_style else ())
            self.text.insert('end', tail + '\n', ('bold',) if bold else ())
        self.text.configure(state='disabled')
        self.scrollfn()


class MainGUI(ThemedTk):

    def __init__(self, testsuite_paths):
        ThemedTk.__init__(self)
        self.settings = Settings(default_config)
        self.testsuite_paths = testsuite_paths
        self.testsuites = {}

        self._build_actions()
        self._build_log_pane()
        self.protocol('WM_DELETE_WINDOW', self._confirm_exit)

        self.log_handler = GuiLogHandler(self.text, self.scrolldown)
        lo.addHandler(self.log_handler)
        lo.debug('GUI started')

    def _actions(self):
        entries = [
            ('scan .fastq files', self.do_scan),
            ('explore .json files', self.do_explore),
            (None, None),
            ('settings', self.do_config),
            ('help', open_help),
        ]
        if logfn:
            entries.append(('show log file', self.do_showlog))
        return entries

    def _build_actions(self):
        frame = tk.Frame(self)
        for label, command in self._actions():
            if label is None:
                tk.Label(frame).pack()
            else:
                tk.Button(frame, text=label, command=command).pack()
        frame.pack(side='left', padx=10)

    def _build_log_pane(self):
        outer = tk.Frame(self, borderwidth=1, relief='ridge')
        outer.pack(side='left', expand=True, fill='both', padx=5, pady=5)
        tk.Label(outer, text='kvarq log output').pack()
        frame, self.text = scrolled(tk.Text, outer)
        frame.pack(expand=True, fill='both')

    def _confirm_exit(self):
        if tkmessagebox.askyesno(
                'quit KvarQ',
                'really want to exit KvarQ and close all windows?'):
            sys.exit(0)

    def do_config(self, _=None):
        self.settings.show()

    def do_scan(self, _=None):
        SimpleGUI(self.settings, testsuites=self.testsuites,
                  testsuite_paths=self.testsuite_paths)

    def do_explore(self, _=None):
        DirectoryExplorer(None, testsuites=self.testsuites,
                          testsuite_paths=self.testsuite_paths)

    def do_showlog(self, _=None):
        win = ThemedTk(title='contents of logfile (%s)' % logfn,
                       geometry=(-200, -200))
        frame, text = scrolled(tk.Text, win)
        frame.pack(side=tk.TOP, expand=True, fill=tk.BOTH)
        with open(logfn) as fd:
            text.insert(tk.END, fd.read())
        text.yview('moveto', 1.0)

    def scrolldown(self):
        lo_, hi = self.text.yscrollbar.get()
        target = 1 - hi + lo_
        self.text.yscrollbar.set(target, 1)
        self.text.yview('moveto', target)
