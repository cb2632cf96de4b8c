'''
The program's own spans and counters (``kvarq_tpu_torch.profiling``) of
the traced samples on the device trace's clock, and what the layers'
metrics read from them.

One traced sample's ``profiling.collect()`` holds spans ``(name, thread,
start_ns, end_ns)`` on ``time.time_ns()``, the clock of the trace's host
events (an event's ``ts`` in us plus the file's
``baseTimeNanoseconds``), and counters ``{name: total}``.
:py:func:`place` puts a sample's spans on the trace's microseconds; the
readings take the list of placed samples, and read None from a program
without the recorder (no samples) or where no sample holds what they
read.  ``harness.Run.traced_samples`` records each traced sample, and a
run's record holds them placed (``program``). :py:func:`span_ms` and
:py:func:`count_ms` read any span or counter by its name: a metric on a
span or counter that no entry below names needs a reader file alone.
'''

# the threads of a scan: the one calling cli.main, the scan's, the reader's
MAIN, WORKER, READER = 'MainThread', 'analyse-thread', 'kvarq-reader-prefetch'

# what each layer's time a sample reads: program spans, or a reader counter
SPANS = {
    'load_ms': ('cli.load', 'analyse.coverages'),
    'write_ms': ('cli.write',),
    'replay_ms': ('analyse.replay',),
    'bank_ms': ('engine.bank',),
    'wait_ms': ('engine.wait',),
    'emit_ms': ('engine.emit',),
    'read_ms': ('reader.next',),
}
COUNTERS = {
    'sieve_ms': 'reader.sieve_ns',
    'inflate_ms': 'reader.inflate_ns',
}
# the worker's spans that together make the engine's time
# (``info.scantime``) of a sample
ENGINE_PARTS = ('engine.bank', 'engine.wait', 'engine.scan', 'engine.match',
                'engine.emit', 'engine.fold')


def place(collected, base_ns):
    ''' one sample's ``profiling.collect()`` on the trace's clock:
        ``{'spans': [(name, thread, start_us, end_us)], 'counts'}`` '''
    return {'spans': [(n, t, (a - base_ns) / 1e3, (b - base_ns) / 1e3)
                      for n, t, a, b in collected['spans']],
            'counts': dict(collected['counts'])}


def span_ms(samples, names, thread=None):
    ''' the mean a sample of the time in spans named ``names`` (on
        ``thread`` alone, if given), in ms '''
    if not samples:
        return None
    picked = [[e - s for n, t, s, e in p['spans']
               if n in names and thread in (None, t)] for p in samples]
    if not any(picked):
        return None
    return sum(map(sum, picked)) / len(picked) / 1e3


def count_ms(samples, name):
    ''' the mean a sample of a counter of nanoseconds, in ms '''
    if not samples or not any(name in p['counts'] for p in samples):
        return None
    return sum(p['counts'].get(name, 0) for p in samples) / len(samples) / 1e6


def layer_ms(samples, metric):
    ''' the reading of a metric of :py:data:`SPANS` or
        :py:data:`COUNTERS` by its name without the cell's suffix '''
    if metric in COUNTERS:
        return count_ms(samples, COUNTERS[metric])
    return span_ms(samples, SPANS[metric])


def _innermost(spans, thread, t):
    ''' the name of the span of ``thread`` open at ``t`` that started
        last, None where none is '''
    open_ = [(s, n) for n, th, s, e in spans if th == thread and s <= t < e]
    return max(open_)[1] if open_ else None


def label_at(samples, t):
    ''' what held the host at ``t`` (us on the trace's clock): the
        innermost span open on the scan's thread, or failing that on the
        thread that called ``cli.main``, and where that is the wait for
        the reader, the reader thread's span beside it
        (``engine.wait / reader.next``); None where no span is open '''
    if not samples:
        return None
    spans = [s for p in samples for s in p['spans']]
    name = _innermost(spans, WORKER, t) or _innermost(spans, MAIN, t)
    if name == 'engine.wait':
        reader = _innermost(spans, READER, t)
        if reader:
            name += ' / ' + reader
    return name
