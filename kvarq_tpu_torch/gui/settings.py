'''
Settings dialog: a simple form over the (all-integer) scan parameters in
``kvarq_tpu_torch.config.default_config``; values are applied on "save"
only.
'''

import tkinter as tk
import tkinter.messagebox as tkmessagebox

from kvarq_tpu_torch.gui.util import ThemedTk, open_help


def parse_int_settings(raw):
    ''' validate a ``{name: entry-string}`` form; returns ``(values,
        offending_name)`` where exactly one of the two is ``None`` '''
    values = {}
    for name, text in raw.items():
        try:
            values[name] = int(text)
        except ValueError:
            return None, name
    return values, None


class Settings:

    ''' holds the live config dict and (re)opens the edit dialog '''

    def __init__(self, config):
        self.config = config
        self.entries = {}

    def show(self):
        self.win = ThemedTk(title='settings')
        self.win.rowconfigure(1, weight=1)
        self.win.columnconfigure(1, weight=1)
        self.win.rowconfigure(0, minsize=10)

        header = tk.Label(self.win, text='Engine configuration',
                          font=self.win.boldfont)
        header.grid(row=1, column=0, columnspan=2, sticky='w')
        tk.Button(self.win, text='?', command=self.launch_help) \
            .grid(row=1, column=2, sticky='e')

        self.entries = {}
        row = 1
        for name, value in self.config.items():
            row += 1
            tk.Label(self.win, text=name).grid(row=row, column=0,
                                               sticky='w')
            entry = tk.Entry(self.win)
            entry.grid(row=row, column=1, columnspan=2, sticky='ew')
            entry.insert(0, value)
            self.entries[name] = entry

        self.win.rowconfigure(row + 1, minsize=10)
        buttons = tk.Frame(self.win)
        buttons.grid(row=row + 2, column=0, columnspan=3)
        tk.Button(buttons, text='save', command=self.save_cb) \
            .pack(side='left')
        tk.Button(buttons, text='cancel', command=self.cancel_cb) \
            .pack(side='left')
        self.win.bind('<Escape>', lambda _: self.win.close())

    def launch_help(self, _=None):
        open_help(page='gui', anchor='configuring-kvarq')

    def save_cb(self, _=None):
        raw = {name: entry.get() for name, entry in self.entries.items()}
        values, offending = parse_int_settings(raw)
        if offending is not None:
            tkmessagebox.showerror(
                'invalid value',
                'parameter "%s" must be an integer' % offending)
            return
        self.config.update(values)
        self.win.destroy()

    def cancel_cb(self, _=None):
        self.win.destroy()
