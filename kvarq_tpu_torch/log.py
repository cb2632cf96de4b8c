'''
Logging backbone: everything in the package (including the native reader,
via its deferred message buffer) logs through the single
``kvarq_tpu_torch`` logger created here.  Also provides the
``tic``/``toc`` wall-clock phase timers, spans of
:py:mod:`kvarq_tpu_torch.profiling` whose lengths end up at debug level.

Console output format is the reference one (kvarq/log.py) so scripts that
grep stderr keep working.
'''

import functools
import logging
import os.path
import sys
import traceback

from kvarq_tpu_torch.profiling import Span
from kvarq_tpu_torch.util import is_app, is_exe_gui

LINE_FORMAT = ('[%(asctime)s] -%(levelname)s- '
               '%(filename)s:%(lineno)d(%(funcName)s) :: %(message)s')

_RESET = '\033[m'
_BOLD = '\033[1m'

# per-level decoration of the '-LEVEL-' tag (and optionally the message)
_LEVEL_STYLES = {
    'INFO': ('\033[92m', False),        # green tag
    'WARNING': ('\033[97;101m', True),  # white-on-red tag, bold message
    'ERROR': ('\033[97;101m', True),
}


class ColoredFormatter(logging.Formatter):

    ''' highlights the ``-LEVEL-`` tag on ANSI terminals '''

    def format(self, record):
        line = super().format(record)
        style = _LEVEL_STYLES.get(record.levelname)
        if style is None:
            return line
        color, bold_msg = style
        tag = '-%s-' % record.levelname
        head, sep, tail = line.partition(tag)
        if not sep:
            return line
        out = head + color + tag + _RESET
        return out + (_BOLD + tail + _RESET if bold_msg else tail)


def _make_console_handler():
    ''' frozen GUI apps have no console: log to ~/kvarq.log instead; a tty
        gets colors, a redirected stderr plain text '''
    if is_exe_gui() or is_app():
        fname = os.path.join(os.path.expanduser('~'), 'kvarq.log')
        handler = logging.FileHandler(fname)
        handler.setFormatter(logging.Formatter(LINE_FORMAT))
        return handler, fname
    handler = logging.StreamHandler(sys.stderr)
    tty = sys.platform != 'win32' and getattr(sys.stderr, 'isatty', bool)()
    formatter_cls = ColoredFormatter if tty else logging.Formatter
    handler.setFormatter(formatter_cls(LINE_FORMAT))
    return handler, None


# a logger of its own (kvarq_tpu's is 'kvarq'): a process that imports
# both packages prints every line once
lo = logging.getLogger('kvarq_tpu_torch')
_console, logfn = _make_console_handler()
_console.setLevel(logging.DEBUG)
lo.addHandler(_console)
lo.setLevel(logging.INFO)


def set_debug():
    lo.setLevel(logging.DEBUG)


def set_info():
    lo.setLevel(logging.INFO)


def set_warning():
    lo.setLevel(logging.WARNING)


def appendlog(fname):
    ''' additionally append all log output (debug included) to a file '''
    handler = logging.FileHandler(fname)
    handler.setLevel(logging.DEBUG)
    handler.setFormatter(logging.Formatter(LINE_FORMAT))
    lo.addHandler(handler)


# --- wall-clock phase timers ------------------------------------------------

# the intervals opened by tic and not yet closed by toc, by name
_open = {}


def tic(name):
    ''' start a named timer (re-entrant: every tic opens a new interval),
        a span of :py:mod:`kvarq_tpu_torch.profiling` '''
    _open.setdefault(name, []).append(Span(name).__enter__())


def toc(name):
    ''' close the most recent interval of ``name`` and log its duration '''
    s = _open[name].pop()
    s.__exit__(None, None, None)
    lo.debug('toc-tic %s : %.2f ms' % (name, 1e3 * s.seconds))


def tictoc(name):
    ''' decorator: time every call of the wrapped function under ``name`` '''
    def wrap(f):
        @functools.wraps(f)
        def timed(*args, **kwargs):
            tic(name)
            try:
                return f(*args, **kwargs)
            finally:
                toc(name)
        return timed
    return wrap


def format_traceback(exc_info):
    ''' one-line ``file:lineno -> file:lineno`` rendering of a traceback '''
    frames = traceback.extract_tb(exc_info[2])
    return ' -> '.join('%s:%d' % (f[0], f[1]) for f in frames)
