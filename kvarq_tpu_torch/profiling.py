'''
Phase-level scan profiling of the port (counterpart of
kvarq_tpu/profiling.py): a wall-clock per-phase breakdown persisted into
the result json (``info.phases``) plus, with a directory, a
``torch.profiler`` trace of the scan on the host and the card, exported
as a Chrome trace (open it in Perfetto or chrome://tracing).

torch.profiler records the host ops of the thread that starts it, so the
trace is a context (:py:meth:`ScanProfiler.trace`) entered by the thread
that runs the scan.  Unlike kvarq_tpu's, a trace that cannot start
raises instead of warning: a profile without the device would hide it.
'''

import os
import time
from contextlib import contextmanager

import torch

from kvarq_tpu_torch.log import lo

# file name of the exported trace inside the trace directory
TRACE_FILE = 'kvarq_scan.pt.trace.json'


class ScanProfiler:
    ''' collects named wall-clock phases (``.phases`` dict, seconds) and,
        when constructed with a directory, traces :py:meth:`trace` blocks
        with torch.profiler (CPU, and CUDA when ``device`` is a card) '''

    def __init__(self, trace_dir=None, device='cpu'):
        self.trace_dir = trace_dir
        self.device = torch.device(device)
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
        ''' time a named phase; re-entering a name accumulates '''
        t0 = time.time()
        try:
            yield
        finally:
            self.phases[name] = round(
                self.phases.get(name, 0.0) + time.time() - t0, 4)

    @contextmanager
    def trace(self):
        ''' torch.profiler over the block, exported to the trace directory
            as :py:data:`TRACE_FILE`; a no-op without a directory '''
        if not self.trace_dir:
            yield
            return
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if self.device.type == 'cuda':
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(self.trace_dir, exist_ok=True)
        lo.info('torch.profiler trace (%s) -> %s' % (
            ', '.join(a.name for a in activities), self.trace_dir))
        with profile(activities=activities) as prof:
            yield
            if self.device.type == 'cuda':
                torch.cuda.synchronize(self.device)
        path = os.path.join(self.trace_dir, TRACE_FILE)
        prof.export_chrome_trace(path)
        lo.info('trace written to %s (open with Perfetto or chrome://tracing)'
                % path)
