'''
Host-side odds and ends: terminal progress rendering with an ETA estimate,
text histograms, pretty-but-compact JSON writing, frozen-app path helpers,
and the ``summarize`` table builder.

Output formats are kept drop-in compatible with the reference
(kvarq/util.py); the implementations are new.
'''

import csv
import json
import os
import os.path
import sys
import threading
import time
from collections import deque
from math import log

from kvarq_tpu_torch import DOC_URL


# ---------------------------------------------------------------------------
# frozen-app detection + root-relative paths

def _frozen_kind():
    ''' py2exe/py2app set ``sys.frozen`` to a string tag '''
    return getattr(sys, 'frozen', None)


def is_exe_console():
    return _frozen_kind() == 'console_exe'


def is_exe_gui():
    return _frozen_kind() == 'windows_exe'


def is_exe():
    return _frozen_kind() in ('console_exe', 'windows_exe')


def is_app():
    return _frozen_kind() == 'macosx_app'


def get_root_path(*parts):
    ''' absolute path of a file relative to the repository root (the
        directory containing the ``kvarq_tpu_torch`` package) '''
    pkg_dir = os.path.dirname(os.path.abspath(__file__))
    return os.path.join(os.path.dirname(pkg_dir), *parts)


def get_help_path(page='index', anchor=None, need_url=False):
    ''' best available location of a documentation page: locally built
        html, local markdown source, or the online documentation '''
    html_dir = get_root_path('docs', '_build', 'html')
    if os.path.isdir(html_dir):
        target = os.path.abspath(os.path.join(html_dir, page + '.html'))
        return target + ('#' + anchor if anchor else '')

    md_dir = get_root_path('docs')
    if os.path.isdir(md_dir):
        target = os.path.abspath(os.path.join(md_dir, page + '.md'))
        if os.path.exists(target):
            return target + (':' + anchor if anchor else '')

    return DOC_URL + '/' + page + '.html' + ('#' + anchor if anchor else '')


# ---------------------------------------------------------------------------
# progress bar

def format_duration(secs):
    ''' humanize a duration: ``95`` -> ``'1m 35s'`` '''
    secs = int(secs)
    h, rem = divmod(secs, 3600)
    m, s = divmod(rem, 60)
    if h:
        return '%dh %dm %ds' % (h, m, s)
    if m:
        return '%dm %ds' % (m, s)
    return '%ds' % s


class ProgressBar:

    '''
    one-line terminal progress bar with a percent label and an ETA, meant
    to be re-printed in place at ~1 Hz::

        [========>     32%                ] 1m 30s / 4m 14s
    '''

    def __init__(self, total, width=50, ETA=True, r=None, ETAbuflen=100):
        '''
        :param total: value of ``update()`` meaning "done"
        :param width: total width of the ``[...]`` part
        :param ETA: append ``elapsed / estimated-total``
        :param r: string printed before the bar to rewind the cursor
            (default: ``\\r`` on windows consoles, else newline + ANSI
            cursor-up so the bar survives interleaved log lines)
        :param ETAbuflen: number of recent samples the ETA averages over
        '''
        self.total = total
        self.width = width
        self.show_eta = ETA
        self.started = None
        self._samples = deque(maxlen=ETAbuflen)
        if r is not None:
            self.r = r
        elif sys.platform.startswith('win'):
            self.r = '\r'
        else:
            self.r = '\n\x1b[A'

    # kept as a (read-only) attribute for backward compatibility
    @property
    def ETA(self):
        return self.show_eta

    def start(self):
        self.started = time.time()

    def update(self, done):
        ''' record current progress (same unit as ``total``) '''
        self._samples.append((done, time.time()))

    @property
    def done(self):
        return self._samples[-1][0] if self._samples else None

    @property
    def when(self):
        return self._samples[-1][1] if self._samples else None

    def _estimate_total_secs(self):
        ''' average linear extrapolation over the sample buffer; ``None``
            while there is not enough signal (first 10 s, or no nonzero
            progress sample yet) '''
        if self.when - self.started <= 10:
            return None
        estimates = [(when - self.started) * self.total / done
                     for done, when in self._samples if done]
        if not estimates:
            return None
        secs = sum(estimates) / len(self._samples)
        if secs > 120:
            secs -= secs % 10  # don't pretend to know better
        return secs

    def _eta_str(self):
        if not self.show_eta:
            return ''
        elapsed = format_duration(self.when - self.started)
        secs = self._estimate_total_secs()
        if secs is None:
            return ' %s / ???' % elapsed
        return ' %s / %s   ' % (elapsed, format_duration(secs))

    def __str__(self):
        if not self.started:
            self.start()
        fraction = min(0.9999, float(self.done) / self.total)
        label = '%3d%% ' % int(100 * fraction)

        # bar made of two half-width cells with the label in between;
        # the arrow sweeps the left cell first, then the right one
        cell = (self.width - len(label) - 2) // 2
        sweep = fraction * 2
        left = self._cell(min(sweep, 1.0), cell)
        right = self._cell(max(sweep - 1.0, 0.0), cell) if sweep > 1 \
            else ' ' * cell
        return self.r + '[' + left + label + right + ']' + self._eta_str()

    @staticmethod
    def _cell(p, width):
        filled = int(p * width)
        return '=' * filled + '>' + ' ' * int((1 - p) * width)

    @classmethod
    def run_watched(cls, f_cb, progress_cb, dt=1.):
        ''' run ``f_cb()`` on a worker thread while re-printing a progress
            bar fed by ``progress_cb()`` every ``dt`` seconds; returns
            ``f_cb``'s result '''
        outcome = []

        def work():
            outcome.append(f_cb())

        worker = threading.Thread(target=work, name='progressbar-thread')
        bar = cls(total=1.)
        worker.start()
        bar.start()
        print(file=sys.stderr)
        while worker.is_alive():
            bar.update(progress_cb())
            print(str(bar), file=sys.stderr)
            worker.join(dt)
        return outcome[0] if outcome else None


# ---------------------------------------------------------------------------
# text histogram

class TextHist:

    '''
    renders a fixed-width ascii histogram::

        [   0-  20]  33 (10%) ********
        [  20-  40] 185 (50%) *******************************

        totaling 185, average 17.35

    bucket boundaries and the (integer) percent/star arithmetic follow the
    reference renderer (kvarq/util.py:129-209) so terminal output is
    unchanged.
    '''

    def __init__(self, bins=15, width=65, title=None):
        self.bins = bins
        self.width = width
        self.title = title

    @staticmethod
    def _nice_bin_width(raw):
        ''' truncate to two significant digits, at least 1 '''
        if not raw:
            return 0
        magnitude = 10 ** (int(log(raw) / log(10)) - 1)
        return max(1., int(raw / magnitude) * magnitude)

    def _iter_values(self, data, indexed):
        ''' yield (value, weight) pairs in ascending value order '''
        if indexed:
            for value, count in enumerate(data):
                yield value, count
        else:
            for value in data:
                yield value, 1

    def draw(self, data, indexed=False):
        '''
        :param data: sorted values (``indexed=False``) or per-index
            occurrence counts (``indexed=True``)
        :returns: the histogram as a multi-line string
        '''
        if not data:
            return 'no data --> CANNOT GENERATE HISTOGRAM'
        if indexed:
            top_value = len(data)
            span = len(data)
        else:
            if data[-1] == 0:
                return 'all data zero --> CANNOT GENERATE HISTOGRAM'
            top_value = data[-1]
            span = data[-1] - data[0]
        bw = self._nice_bin_width(span / float(self.bins))
        if not bw:
            return 'bw=0 --> CANNOT GENERATE HISTOGRAM'

        # bucket b covers values in (b*bw, (b+1)*bw]: a value belongs to
        # the first bucket whose upper edge it does not exceed; zero-weight
        # values still advance the bucket list (so gaps render as 0-rows)
        buckets = [0]
        weighted_sum = 0
        for value, weight in self._iter_values(data, indexed):
            while value > len(buckets) * bw:
                buckets.append(0)
            buckets[-1] += weight
            weighted_sum += weight * value
        # a still-open trailing bucket is only shown if it collected weight
        if len(buckets) > 1 and buckets[-1] == 0:
            buckets.pop()

        top = max(buckets)
        total = sum(buckets)
        if not total:
            return 'all data zero --> CANNOT GENERATE HISTOGRAM'
        label_digits = max(4, int(log(top_value) / log(10)) + 1)
        count_digits = int(log(max(1, top)) / log(10)) + 1
        line_fmt = '[%%%dd-%%%dd] %%%dd (%%2d%%%%)' % (
            label_digits, label_digits, count_digits)

        lines = []
        if self.title:
            lines += [self.title, '-' * len(self.title)]
        for b, count in enumerate(buckets):
            lines.append(line_fmt % (b * bw, (b + 1) * bw, count,
                                     100 * count // total)
                         + '*' * (self.width * count // top))

        denominator = sum(data) if indexed else len(data)
        lines.append('totaling %d, average %.2f'
                     % (top, float(weighted_sum) / denominator))
        return '\n'.join(lines)


# ---------------------------------------------------------------------------
# json / csv / xls output

def json_dump(data, fd, indent=2, max_indent_level=2):
    '''
    write ``data`` as JSON that is readable *and* diffable: containers are
    pretty-printed (``indent`` spaces per level) down to
    ``max_indent_level``, anything deeper goes on a single line.  The
    byte-level format matches the reference result files
    (kvarq/util.py:272-294).
    '''
    def compact(obj):
        return json.dumps(obj, separators=(',', ': '))

    def write(obj, level):
        if not isinstance(obj, (dict, list, tuple)) or not obj \
                or level >= max_indent_level:
            fd.write(compact(obj))
            return
        pad = ' ' * (indent * (level + 1))
        if isinstance(obj, dict):
            fd.write('{')
            for n, (key, value) in enumerate(obj.items()):
                fd.write((',' if n else '') + '\n' + pad)
                fd.write(compact(key if isinstance(key, str) else str(key)))
                fd.write(': ')
                write(value, level + 1)
        else:
            fd.write('[')
            for n, value in enumerate(obj):
                fd.write((',' if n else '') + '\n' + pad)
                write(value, level + 1)
        fd.write('\n' + ' ' * (indent * level)
                 + ('}' if isinstance(obj, dict) else ']'))

    write(data, 0)


def _load_xlwt():
    try:
        import xlwt
        return xlwt
    except ImportError:
        return None


class csv_xls_writer:

    ''' row-by-row table writer; ``.csv`` always works, ``.xls`` needs the
        optional ``xlwt`` module (and silently falls back to ``.csv``
        otherwise) '''

    @classmethod
    def add_extension(cls, fname):
        stem = os.path.splitext(fname)[0]
        return stem + ('.xls' if _load_xlwt() else '.csv')

    def __init__(self, fname, autoflush=True, sheet_name='exported data'):
        self.autoflush = autoflush
        xlwt = _load_xlwt() if fname.endswith('.xls') else None
        if xlwt:
            self.fname = fname
            self.csv = None
            self.easyxf = xlwt.easyxf
            self.wb = xlwt.Workbook()
            self.ws = self.wb.add_sheet(sheet_name)
            self.row = 0
        else:
            if fname.endswith('.xls'):
                fname = fname[:-len('.xls')] + '.csv'
            elif not fname.endswith('.csv'):
                raise IOError('can only export data to .csv or .xls')
            self.fname = fname
            self.csv = csv.writer(open(fname, 'w', newline=''))

    def writerow(self, row, colors=None):
        '''
        :param row: list of cell values
        :param colors: optional ``{column_index: excel_color}`` (xls only)
        '''
        if self.csv:
            self.csv.writerow(row)
            return
        for col, value in enumerate(row):
            if colors and col in colors:
                style = self.easyxf('pattern: pattern solid;')
                style.pattern.pattern_fore_colour = colors[col]
                self.ws.write(self.row, col, value, style)
            else:
                self.ws.write(self.row, col, value)
        self.row += 1
        if self.autoflush:
            self.flush()

    def flush(self):
        if not self.csv:
            self.wb.save(self.fname)


class JsonSummary:

    ''' aggregates the ``analyses`` of several result ``.json`` files into
        one csv table (one row per file; columns in first-seen order;
        list-valued results span several columns) '''

    _FIXED = ('filename', 'filesize', 'scantime')

    def __init__(self):
        self._rows = {}                       # fname -> {column: value}
        self._spans = dict.fromkeys(self._FIXED, 1)   # ordered

    def add(self, fname):
        ''' pull ``analyses`` + file metadata out of one result file '''
        with open(fname) as fd:
            doc = json.load(fd)
        row = dict(filename=fname,
                   filesize=sum(doc['info']['size']),
                   scantime=int(doc['info']['scantime']))
        for column, value in doc['analyses'].items():
            row[column] = value
            width = len(value) if isinstance(value, (list, tuple)) else 1
            self._spans[column] = max(self._spans.get(column, 1), width)
        self._rows[fname] = row

    @staticmethod
    def _cells(value, span):
        ''' pad a (possibly list-valued, possibly missing) value to span '''
        cells = list(value) if isinstance(value, (list, tuple)) else [value]
        return cells + [None] * (span - len(cells))

    def dump(self, fd=None):
        ''' write the table in csv format (default: stdout) '''
        out = csv.writer(fd or sys.stdout)
        out.writerow(sum(([column] * span
                          for column, span in self._spans.items()), []))
        for row in self._rows.values():
            out.writerow(sum((self._cells(row.get(column), span)
                              for column, span in self._spans.items()), []))
