'''
Plot windows drawn directly on a Tk canvas (no matplotlib): per-position
coverage with colored mutation stacks and mean±std guides, histograms of
trimmed readlengths / hits-per-template / mean coverage, and spoligo bars.

All plots share one bar-chart base class; the concrete classes only
provide their height scaling, decorations and mouse-over descriptions.
'''

from collections import Counter
from math import log
import tkinter as tk
import tkinter.font as tkfont
import tkinter.messagebox as tkmessagebox

from kvarq_tpu_torch.gui.util import ThemedTk


def nice_bin_width(raw):
    ''' truncate a raw bin width to two significant digits, at least 1 '''
    if raw > 0:
        magnitude = 10 ** (int(log(raw) / log(10)) - 1)
        raw = int(raw / magnitude) * magnitude
    return max(1., raw)


def histogram_bins(data, indexed, nbins):
    '''
    bucket ``data`` (sorted values, or per-index counts with
    ``indexed=True``) into bins of a nicely rounded width;
    :returns: ``(bin_counts, bin_width)``
    '''
    if indexed:
        span = len(data)
    else:
        data = sorted(data)
        span = data[-1] - data[0]
    width = nice_bin_width(span / float(nbins))

    buckets = [0]
    for i, value in enumerate(data):
        position = i if indexed else value
        while position > len(buckets) * width:
            buckets.append(0)
        buckets[-1] += value if indexed else 1
    if len(buckets) > 1 and not buckets[-1]:
        buckets.pop()
    return buckets, width


class PlotCanvas:

    ''' canvas with margins, bottom-left-origin drawing helpers, tick
        rendering and a mouse-position readout label '''

    def __init__(self, parent, data):
        self.frame = tk.Frame(parent)
        self.grid = self.frame.grid
        self.pack = self.frame.pack

        self.canvas = tk.Canvas(self.frame)
        self.canvas.pack(fill='both', expand=1)
        self.canvas.bind('<Configure>', self.update)
        self.canvas.bind('<Motion>', self.motion)

        self.label = tk.Label(self.frame)
        self.label.pack()

        self.margin = [20, 20, 20, 20]  # top right bottom left
        self.tick_length = 8
        self.tick_width = 2
        self.tick_font = tkfont.Font(self.canvas, size=10)
        self.data = data

    # --- coordinate helpers (origin at bottom-left inside margins) ------

    def width(self):
        return self.canvas.winfo_width() - self.margin[1] - self.margin[3]

    def height(self):
        return self.canvas.winfo_height() - self.margin[0] - self.margin[2]

    def is_inside(self, x, y):
        return (self.margin[3] <= x
                < self.canvas.winfo_width() - self.margin[1]
                and self.margin[0] <= y
                < self.canvas.winfo_height() - self.margin[2])

    def get_index(self, x):
        return len(self.data) * (x - self.margin[3]) // max(self.width(), 1)

    def _flip(self, y):
        return self.canvas.winfo_height() - self.margin[2] - y

    def create_rectangle(self, x, y, w, h, *args, **kwargs):
        self.canvas.create_rectangle(
            self.margin[3] + x, self._flip(y),
            self.margin[3] + x + w, self._flip(y + h), *args, **kwargs)

    def create_line(self, x1, y1, x2, y2, *args, **kwargs):
        self.canvas.create_line(
            self.margin[3] + x1, self._flip(y1),
            self.margin[3] + x2, self._flip(y2), *args, **kwargs)

    # --- ticks -----------------------------------------------------------

    def xticks(self, ticks, labels=None):
        labels = labels or [str(t) for t in ticks]
        w = self.width()
        base = self.canvas.winfo_height() - self.margin[2] // 2
        for tick, text in zip(ticks, labels):
            x = int(w * (tick + 0.5) / len(self.data))
            self.create_line(x, 0, x, self.tick_length,
                             fill='black', width=self.tick_width)
            self.canvas.create_text(self.margin[3] + x, base, text=text)

    @staticmethod
    def transform_ylabel(number):
        for cutoff, suffix in ((1e9, 'G'), (1e6, 'M'), (1e3, 'k')):
            if number > cutoff:
                return '%.2f%s' % (number / cutoff, suffix)
        return str(number)

    def yticks(self, ticks, labels=None):
        # empty or all-zero data has no height scale: draw no tick
        # (kvarq_tpu's version divides by max(self.data) unguarded)
        top = max(self.data, default=0)
        if not top:
            return
        labels = labels or [self.transform_ylabel(t) for t in ticks]
        h = self.height()
        ch = self.canvas.winfo_height()
        for tick, text in zip(ticks, labels):
            y = h * tick // top
            self.create_line(0, y, self.tick_length, y,
                             fill='black', width=self.tick_width)
            self.canvas.create_text(self.margin[3] // 2,
                                    ch - self.margin[2] - y, text=text)

    # --- hooks -------------------------------------------------------------

    def update(self, e=None):
        pass

    def motion(self, e=None):
        pass


class BarPlot(PlotCanvas):

    ''' renders ``self.data`` as vertical bars; subclasses override
        :py:meth:`describe` (mouse-over text), :py:meth:`bar_scale`
        (pixels per unit) and :py:meth:`decorate` (extra drawing) '''

    BAR_FILL = 'gray'

    def bar_scale(self, h):
        return float(h) / max(max(self.data), 1)

    def bar_bounds(self, i, w):
        x0 = w * i // len(self.data)
        return x0, w * (i + 1) // len(self.data) - x0

    def describe(self, i):
        return ''

    def decorate(self, w, h):
        pass

    def motion(self, e):
        if not self.is_inside(e.x, e.y):
            self.label.config(text='(mouse outside graph)')
            return
        i = max(0, min(self.get_index(e.x), len(self.data) - 1))
        self.label.config(text=self.describe(i))

    def update(self, e=None):
        self.canvas.delete('all')
        w, h = self.width(), self.height()
        scale = self.bar_scale(h)
        for i, value in enumerate(self.data):
            x0, bw = self.bar_bounds(i, w)
            self.create_rectangle(x0, 0, bw, int(value * scale),
                                  fill=self.BAR_FILL, outline='')
        self.decorate(w, h)


class CoverageDisplay(BarPlot):

    ''' per-position depth bars with stacked mutation colors, red
        region-of-interest borders and dashed mean/mean±std guides '''

    BASE_COLORS = {'A': 'blue', 'C': 'cyan', 'G': 'green', 'T': 'red',
                   'N': 'black'}

    def __init__(self, parent, pos0, coverage):
        super().__init__(parent, coverage.coverage)
        self.coverage = coverage
        self.pos0 = pos0

    def bar_scale(self, h):
        # cap bar growth so low-coverage plots stay readable
        return min(3., super().bar_scale(h))

    def describe(self, i):
        if self.pos0:
            text = 'pos=' + str(self.pos0 + i - self.coverage.start)
        else:
            text = 'pos=?'
        text += ' coverage=' + str(self.coverage.coverage[i])
        mutations = self.coverage.mutations.get(i)
        if mutations:
            text += ' mutations=' + ', '.join(
                '%dx %s' % (n, base)
                for base, n in Counter(mutations).items())
        return text

    def update(self, e=None):
        super().update(e)
        w, h = self.width(), self.height()
        scale = self.bar_scale(h)

        # mutation stacks on top of the depth bars
        for i in range(len(self.data)):
            x0, bw = self.bar_bounds(i, w)
            for j, base in enumerate(
                    sorted(self.coverage.mutations.get(i, ''))):
                y0 = int(j * scale)
                self.create_rectangle(
                    x0, y0, bw, int((j + 1) * scale) - y0,
                    fill=self.BASE_COLORS.get(base, 'black'), outline='')

        # region-of-interest borders
        for i in (self.coverage.start, self.coverage.stop):
            lx = w * i // len(self.data)
            self.create_line(lx, 0, lx, h, fill='red', width=2)

        # mean / mean±std guides
        mean = self.coverage.mean(include_margins=False)
        std = self.coverage.std(include_margins=False)
        for value, dash in ((mean - std, (2, 5)), (mean, (5, 3)),
                            (mean + std, (2, 5))):
            ly = int(value * scale)
            self.create_line(0, ly, w, ly, fill='black', dash=dash)

        self.create_rectangle(0, 0, w, h, fill='', outline='black')


class ReadlengthDisplay(BarPlot):

    def __init__(self, parent, data):
        super().__init__(parent, list(data))
        self.margin[3] = 60

    def describe(self, i):
        return '%d reads with length=%d' % (self.data[i], i)

    def decorate(self, w, h):
        self.create_line(0, 0, w, 0, fill='black')
        self.create_line(0, 0, 0, h, fill='black')
        populated = [i for i, n in enumerate(self.data) if n > 0]
        if populated:
            greatest = max(self.data)
            self.xticks([populated[0], populated[-1],
                         self.data.index(greatest)])
            self.yticks([greatest])


class HitHistogramDisplay(BarPlot):

    def __init__(self, parent, data, indexed=False, nbins=15):
        bins, width = histogram_bins(data, indexed, nbins + 1)
        super().__init__(parent, bins)
        self.binwidth = width
        self.smallest = min(data)
        self.largest = max(data)

    def describe(self, i):
        a, b = self.binwidth * i, self.binwidth * (i + 1) - 1
        if i == 0:
            a = self.smallest
        if i == len(self.data) - 1:
            b = self.largest
        text = '%d templates with %d' % (self.data[i], a)
        if a != b:
            text += '-' + str(b)
        return text + ' hits'

    def decorate(self, w, h):
        self.create_rectangle(0, 0, w, h, fill='', outline='black')


class MeanCoverageDisplay(HitHistogramDisplay):

    def describe(self, i):
        return '%d templates with medium coverage %d-%d' % (
            self.data[i], self.binwidth * i, self.binwidth * (i + 1))


class SpoligoDisplay(ReadlengthDisplay):

    def __init__(self, parent, data):
        super().__init__(parent, data)
        self.margin[1] = self.margin[3] = 0

    def describe(self, i):
        return 'spoligo%d : %d hits' % (i, self.data[i])

    def decorate(self, w, h):
        pass


def _plot_window(data, title, geometry, display_cls, empty_title,
                 empty_message, **display_kwargs):
    ''' open a ThemedTk window around a display class, or show an info box
        when there is nothing to plot; returns the window or None '''
    if not data or not max(data):
        tkmessagebox.showinfo(empty_title, empty_message)
        return None
    win = ThemedTk(title=title, esc_closes=True, geometry=geometry)
    display = display_cls(win, data=data, **display_kwargs)
    display.pack(fill='both', expand=1)
    win.display = display
    return win


class CoverageWindow:

    def __init__(self, test, coverage):
        if not coverage.coverage or not max(coverage.coverage):
            tkmessagebox.showinfo('cannot show coverage',
                                  'this template has an empty coverage')
            return
        self.win = ThemedTk(title=str(test), esc_closes=True,
                            geometry=(800, 600))
        self.cd = CoverageDisplay(self.win,
                                  getattr(test.template, 'start', None),
                                  coverage)
        self.cd.pack(fill='both', expand=1)


class ReadlengthWindow:

    def __init__(self, readlengths):
        self.win = _plot_window(
            readlengths, 'Length of quality-cut reads', (600, 400),
            ReadlengthDisplay,
            'cannot show readlengths', 'no reads found')


class HitHistogramWindow:

    def __init__(self, data, indexed=False):
        self.win = _plot_window(
            data, 'Histogram of hits/template', (600, 400),
            HitHistogramDisplay,
            'cannot show hits/template', 'no hits to template found',
            indexed=indexed)


class MeanCoverageWindow:

    def __init__(self, data, indexed=False):
        self.win = _plot_window(
            data, 'Mean coverage of templates', (600, 400),
            MeanCoverageDisplay,
            'cannot show mean coverage', 'no hits to template found',
            indexed=indexed)


class SpoligoWindow:

    def __init__(self, spoligos):
        self.win = _plot_window(
            spoligos, 'Hits/spoligo', (600, 400), SpoligoDisplay,
            'cannot show hits/spoligo', 'no spoligos found')
