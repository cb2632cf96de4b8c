'''
The readings of the metrics, one function a quantity, over a run's record
(``harness.Run.record``). Each metric's file under ``perfbench/metrics/``
names the function it reads by; which cells report a metric is
``BENCHMARK.json``'s ``workloads`` alone. A function returns None where
the run holds nothing to read.
'''

from perfbench.lib import program, trace


def reads_per_s(record):
    ''' the reads of every sample completed in the window (a mate counts
        as a read; the reads the benchmark wrote), over the time from the
        window's start to the last sample's end '''
    if not record['scans']:
        return None
    return (record['reads_per_sample'] * len(record['scans'])
            / record['window_s'])


def setup_s(record):
    ''' seconds from the benchmark's start to its window's, less the
        benchmark's own making of the samples: imports, the CUDA context
        and a warm-up scan that builds (on a fresh checkout), loads and
        runs every kernel of the cell '''
    return record['setup_s']


def _mean_ms(values):
    values = [v for v in values if v is not None]
    if not values:
        return None
    return 1e3 * sum(values) / len(values)


def engine_ms(record):
    ''' the mean per sample of ``info.scantime``, the engine's own time
        of a scan (``countseqs`` or ``findseqs``: reader, inflate, sieve,
        scanner or matcher, the counts' fold or ``_emit``) '''
    return _mean_ms([s['scantime_s'] for s in record['scans']])


def cli_ms(record):
    ''' the mean per sample of the benchmark's span around ``cli.main``
        less that scan's engine time: the testsuite load, the hits'
        replay (``-H``), the calls, the encoding and the JSON write '''
    return _mean_ms([s['wall_s'] - s['scantime_s'] for s in record['scans']
                     if s['scantime_s'] is not None])


def kernel_ms(record):
    ''' device time of the kernels per traced sample, from the
        torch.profiler trace of the samples traced after the window
        (every kernel a scan launches: K1, S1, H1, the compaction's and
        the bank build's) '''
    tr = record['trace']
    if tr is None or not trace.samples(tr):
        return None
    return (sum(trace.us_by_name(tr, ('kernel',)).values())
            / trace.samples(tr) / 1e3)


def card_kernel_ms(record):
    ''' device time of the kernels a sample over the whole window: every
        kernel the window's scans launched, from the profiler's trace of
        the window's device activity, over the window's samples '''
    tr = record.get('window_trace')
    if tr is None or not record['scans']:
        return None
    us = sum(e - s for _, cat, s, e in tr['device'] if cat == 'kernel')
    if not us:
        return None
    return us / len(record['scans']) / 1e3


def device_idle_pct(record):
    ''' the share of the traced samples' window (from the first traced
        sample's start to the last one's end) in which no kernel, copy or
        fill runs on the device, in % '''
    tr = record['trace']
    if tr is None or not trace.window_us(tr):
        return None
    return 100.0 * (1.0 - trace.busy_us(tr) / trace.window_us(tr))


# --- the program's own spans and counters in the traced samples ------------


def read_ms(record):
    ''' the reader's time a traced sample: ``reader.next`` spans (one
        native batch each) on the reader's thread '''
    return program.layer_ms(record['program'], 'read_ms')


def sieve_ms(record):
    ''' the sieve's thread time a traced sample, summed over the
        reader's C workers (counter ``reader.sieve_ns``) '''
    return program.layer_ms(record['program'], 'sieve_ms')


def inflate_ms(record):
    ''' the decode threads' busy time a traced sample (counter
        ``reader.inflate_ns``) '''
    return program.layer_ms(record['program'], 'inflate_ms')


def load_ms(record):
    ''' the testsuites' load a traced sample: ``cli.load`` and
        ``analyse.coverages`` '''
    return program.layer_ms(record['program'], 'load_ms')


def replay_ms(record):
    ''' the hits' replay into coverage a traced sample
        (``analyse.replay``, under ``-H``) '''
    return program.layer_ms(record['program'], 'replay_ms')


def write_ms(record):
    ''' the result's encoding and JSON write a traced sample
        (``cli.write``) '''
    return program.layer_ms(record['program'], 'write_ms')


def emit_ms(record):
    ''' ``_emit`` a traced sample (``engine.emit``, under ``-H``) '''
    return program.layer_ms(record['program'], 'emit_ms')
