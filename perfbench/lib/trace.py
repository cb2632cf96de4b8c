'''
The reduction of a ``torch.profiler`` Chrome trace to what the per-layer
metrics read: the benchmark's own spans (``perfbench.*`` annotations of
the thread that drives the samples) and the device's activity (kernels,
copies, fills), both on the trace's clock in microseconds, and the
clock's origin, which puts the program's spans on it
(:py:func:`perfbench.lib.program.place`).
'''

import json

from perfbench.lib import program

DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
SPAN_PREFIX = 'perfbench.'


def reduce(path):
    ''' ``{'spans': [(name, start, end)], 'device': [(name, cat, start,
        end)], 'base_ns': baseTimeNanoseconds}`` from the trace file
        ``path`` '''
    with open(path) as fd:
        data = json.load(fd)
    events = data.get('traceEvents', [])
    spans, device = [], []
    for e in events:
        if e.get('ph') != 'X' or 'dur' not in e:
            continue
        cat, name = e.get('cat', ''), e.get('name', '')
        start = float(e['ts'])
        end = start + float(e['dur'])
        if cat in DEVICE_CATS:
            device.append((name, cat, start, end))
        elif cat == 'user_annotation' and name.startswith(SPAN_PREFIX):
            spans.append((name, start, end))
    spans.sort(key=lambda s: s[1])
    device.sort(key=lambda d: d[2])
    return {'spans': spans, 'device': device,
            'base_ns': int(data.get('baseTimeNanoseconds', 0))}


def device_activity(events):
    ''' ``{'spans': [], 'device': [(name, cat, start, end)], 'base_ns':
        0}``, as :py:func:`reduce` gives, from the profiler's events
        (``kineto_results.events()``) with no trace file: the events on
        the device, in microseconds, named copies and fills as the
        trace's export names them and every other one a kernel '''
    from torch.autograd import DeviceType
    device = []
    for e in events:
        if e.device_type() != DeviceType.CUDA:
            continue
        name = e.name()
        cat = ('gpu_memcpy' if name.startswith('Memcpy') else
               'gpu_memset' if name.startswith('Memset') else 'kernel')
        start = e.start_ns() / 1e3
        device.append((name, cat, start, start + e.duration_ns() / 1e3))
    device.sort(key=lambda d: d[2])
    return {'spans': [], 'device': device, 'base_ns': 0}


def window(tr):
    ''' (start, end) of the traced samples, None without any '''
    samples = [s for s in tr['spans'] if s[0].startswith('perfbench.sample')]
    if not samples:
        return None
    return samples[0][1], samples[-1][2]


def _clipped(tr, cats=DEVICE_CATS):
    win = window(tr)
    if win is None:
        return []
    a, b = win
    return [(n, c, max(s, a), min(e, b)) for n, c, s, e in tr['device']
            if c in cats and e > a and s < b]


def busy_intervals(tr):
    ''' the union of device activity inside the window, as sorted
        disjoint (start, end) '''
    out = []
    for _, _, s, e in sorted(_clipped(tr), key=lambda d: d[2]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def busy_us(tr):
    return sum(e - s for s, e in busy_intervals(tr))


def window_us(tr):
    win = window(tr)
    return None if win is None else win[1] - win[0]


def samples(tr):
    return sum(1 for s in tr['spans'] if s[0].startswith('perfbench.sample'))


def us_by_name(tr, cats=DEVICE_CATS):
    ''' {operation name: microseconds} of the device operations of
        ``cats`` (kernels, copies and fills by default) inside the
        window '''
    out = {}
    for n, _, s, e in _clipped(tr, cats):
        out[n] = out.get(n, 0.0) + e - s
    return out


def idle_gaps(tr, placed=None):
    ''' [(label, microseconds)] of the gaps in the device's activity
        inside the window, cut where a sample's span starts or ends and
        labelled by the span that held the host: a sample's scan, with
        what held the program at the gap's middle where the program's
        spans (``placed``) say (``in sample.s0 / engine.wait /
        reader.next``), or between samples '''
    win = window(tr)
    if win is None:
        return []
    a, b = win
    spans = [s for s in tr['spans'] if s[0].startswith('perfbench.sample')]
    cuts = sorted({t for _, s, e in spans for t in (s, e)})
    gaps, last = [], a
    for s, e in busy_intervals(tr) + [(b, b)]:
        if s > last:
            edges = [last] + [c for c in cuts if last < c < s] + [s]
            gaps += list(zip(edges[:-1], edges[1:]))
        last = max(last, e)
    out = []
    for s, e in gaps:
        mid = (s + e) / 2
        label = 'between samples'
        for name, ss, se in spans:
            if ss <= mid < se:
                label = 'in ' + name[len(SPAN_PREFIX):]
                inner = program.label_at(placed, mid)
                if inner:
                    label += ' / ' + inner
                break
        out.append((label, e - s))
    return out
