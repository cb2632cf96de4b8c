'''
The port's one tracing facility: spans and counters recorded from every
thread of a scan, and the phase-level scan profile of ``scan --profile``
(counterpart of kvarq_tpu/profiling.py).

The recorder: :py:func:`span` (a context) records ``(name, thread name,
start_ns, end_ns)`` on ``time.time_ns()``, the clock of the host events
of a ``torch.profiler`` trace (its events' ``ts`` plus the file's
``baseTimeNanoseconds``), so the spans of every thread of the program
land on a device trace with no anchor.  :py:func:`count` adds to a named
counter.  Both record only inside :py:func:`recording`; outside it a
span costs one test of a module flag and returns a shared no-op, and a
count returns at once.  :py:func:`collect` hands over what was recorded
since its last call.  Spans sit at batch level and above, never a read,
a record or a hit.  Recording is on under ``scan --profile`` or through
this API alone.

The scan profile (:py:class:`ScanProfiler`): a wall-clock per-phase
breakdown persisted into the result json (``info.phases``), each phase
recorded as the span ``cli.<phase>``, plus, with a directory, a
``torch.profiler`` trace of the scan on the host and the card, exported
as a Chrome trace (open it in Perfetto or chrome://tracing) into which
the recorded spans of every thread are merged.  torch.profiler records
the host ops of the thread that starts it, so the trace is a context
(:py:meth:`ScanProfiler.trace`) entered by the thread that runs the scan.
Unlike kvarq_tpu's, a trace that cannot start raises instead of warning:
a profile without the device would hide it.  torch is imported only by a
trace, so a scan without ``--profile`` on the host's numpy matcher runs
without it.
'''

import json
import os
import threading
import time
from contextlib import contextmanager

# file name of the exported trace inside the trace directory
TRACE_FILE = 'kvarq_scan.pt.trace.json'

# --- the recorder ------------------------------------------------------------

_recording = False
_lock = threading.Lock()
_spans = []      # (name, thread name, start_ns, end_ns)
_counts = {}


class Span:

    ''' a timed block (``start_ns``/``end_ns`` on ``time.time_ns()``),
        recorded when it ends inside :py:func:`recording`; timed whether
        or not, for the callers that read its length '''

    __slots__ = ('name', 'start_ns', 'end_ns')

    def __init__(self, name):
        self.name = name
        self.start_ns = self.end_ns = None

    def __enter__(self):
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        if _recording:
            item = (self.name, threading.current_thread().name,
                    self.start_ns, self.end_ns)
            with _lock:
                _spans.append(item)
        return False

    @property
    def seconds(self):
        return (self.end_ns - self.start_ns) / 1e9


class _NoSpan:

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


def span(name):
    ''' a context recording the block as the span ``name`` while
        recording is on; a shared no-op otherwise '''
    return Span(name) if _recording else _NO_SPAN


def count(name, n):
    ''' add ``n`` to the counter ``name`` while recording is on '''
    if not _recording:
        return
    with _lock:
        _counts[name] = _counts.get(name, 0) + n


def is_recording():
    return _recording


@contextmanager
def recording():
    ''' record spans and counters, from every thread, inside the block.
        Nested blocks share the record; what the outermost block leaves
        uncollected is dropped when it ends. '''
    global _recording
    was = _recording
    _recording = True
    try:
        yield
    finally:
        _recording = was
        if not was:
            collect()


def collect():
    ''' ``{'spans': [(name, thread name, start_ns, end_ns)], 'counts':
        {name: total}}`` recorded since the last call, which are cleared '''
    global _spans, _counts
    with _lock:
        out = {'spans': _spans, 'counts': _counts}
        _spans, _counts = [], {}
    return out


def _merge_spans(path, spans):
    ''' add ``spans`` to the Chrome trace at ``path`` as ``X`` events on
        its clock, one named thread each, beside torch.profiler's own '''
    with open(path) as fd:
        data = json.load(fd)
    base = int(data.get('baseTimeNanoseconds', 0))
    pid = os.getpid()
    tids = {}
    events = data.setdefault('traceEvents', [])
    for name, thread, start, end in spans:
        if thread not in tids:
            # numeric ids of their own, apart from the profiler's threads
            tids[thread] = 0x7fff0000 + len(tids)
            events.append({'ph': 'M', 'name': 'thread_name', 'pid': pid,
                           'tid': tids[thread], 'args': {'name': thread}})
        events.append({'ph': 'X', 'cat': 'kvarq', 'name': name, 'pid': pid,
                       'tid': tids[thread], 'ts': (start - base) / 1e3,
                       'dur': (end - start) / 1e3})
    with open(path, 'w') as fd:
        json.dump(data, fd)


# --- the scan profile --------------------------------------------------------

class ScanProfiler:
    ''' collects named wall-clock phases (``.phases`` dict, seconds) and,
        when constructed with a directory, traces :py:meth:`trace` blocks
        with torch.profiler (CPU, and CUDA when ``device`` is a card) '''

    def __init__(self, trace_dir=None, device='cpu'):
        self.trace_dir = trace_dir
        self.device = device
        self.phases = {}
        self._t0 = None

    def start(self):
        self._t0 = time.time()
        return self

    def stop(self):
        if self._t0 is not None:
            self.phases['total'] = round(time.time() - self._t0, 4)
        return self.phases

    @contextmanager
    def phase(self, name):
        ''' time a named phase, recorded as the span ``cli.<name>``;
            re-entering a name accumulates '''
        s = Span('cli.' + name)
        try:
            with s:
                yield
        finally:
            self.phases[name] = round(self.phases.get(name, 0.0)
                                      + s.seconds, 4)

    @contextmanager
    def trace(self):
        ''' torch.profiler over the block, exported to the trace directory
            as :py:data:`TRACE_FILE` with the spans recorded so far merged
            in; a no-op without a directory '''
        if not self.trace_dir:
            yield
            return
        import torch
        from torch.profiler import ProfilerActivity, profile
        from kvarq_tpu_torch.log import lo
        device = torch.device(self.device)
        activities = [ProfilerActivity.CPU]
        if device.type == 'cuda':
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(self.trace_dir, exist_ok=True)
        lo.info('torch.profiler trace (%s) -> %s' % (
            ', '.join(a.name for a in activities), self.trace_dir))
        with profile(activities=activities) as prof:
            yield
            if device.type == 'cuda':
                torch.cuda.synchronize(device)
        path = os.path.join(self.trace_dir, TRACE_FILE)
        prof.export_chrome_trace(path)
        with _lock:
            spans = list(_spans)
        _merge_spans(path, spans)
        lo.info('trace written to %s (open with Perfetto or chrome://tracing)'
                % path)
