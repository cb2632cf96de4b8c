'''
Scan-engine API of the port (counterpart of kvarq_tpu/engine/__init__.py,
coverage half): :py:func:`config` / :py:func:`get_config`,
:py:func:`stats`, :py:func:`stop`, :py:func:`install_sigint_counter` and
:py:func:`countseqs`.  The module keeps its own configuration and scan
state; ``kvarq_tpu.engine`` is not touched.

The host input pipeline (native C++ reader, k-mer sieve) is shared with
kvarq_tpu by import; the device step is
:py:class:`kvarq_tpu_torch.engine.tensor_scan.TensorScanner`.  The hit
path (``findseqs``) is not ported yet.
'''

import functools
import os
import threading

import numpy as np

from kvarq_tpu.engine import reader
from kvarq_tpu.log import lo

# engine configuration (defaults match workhorse.c:71-76)
_config = {
    'maxerrors': 0,
    'minoverlap': 20,
    'minreadlength': 10,
    'nthreads': 1,
    'Amin': '!',
    'Azero': '!',
}
# port extensions (not part of get_config(), for json parity)
_extra_config = {
    'device': 'cuda',
    'batchsize': int(os.environ.get('KVARQ_BATCHSIZE', '16384')),
    'sieve': os.environ.get('KVARQ_SIEVE', 'auto'),
}

_lock = threading.Lock()
_running = False
_stop = False
_sigints = 0
_stats = reader.ReaderStats()
_seqhits = np.zeros(0, dtype=np.int64)
_seqbasehits = np.zeros(0, dtype=np.int64)


def config(**kwargs):
    ''' update engine configuration; accepts the reference keys
        (maxerrors, minoverlap, minreadlength, nthreads, Amin, Azero) plus
        ``device`` (a torch device string), ``batchsize`` and ``sieve`` '''
    for key, value in kwargs.items():
        if key in ('Amin', 'Azero'):
            if not isinstance(value, str) or len(value) != 1:
                raise TypeError('%s must be a single character' % key)
            _config[key] = value
        elif key in ('maxerrors', 'minoverlap', 'minreadlength', 'nthreads'):
            _config[key] = int(value)
        elif key in _extra_config:
            _extra_config[key] = value
        else:
            raise TypeError("config() got an unexpected keyword '%s'" % key)


def get_config():
    ''' :returns: the reference-compatible config dict '''
    return dict(_config)


def stop():
    ''' stop a running scan; results are computed from the data parsed so
        far '''
    global _stop
    lo.debug('engine stopped')
    _stop = True


def _sigint_cb(sig, frame):
    global _sigints
    _sigints += 1


def install_sigint_counter():
    ''' count SIGINT instead of raising KeyboardInterrupt, like the C
        engine; call from the main thread (the CLI does) '''
    import signal
    try:
        signal.signal(signal.SIGINT, _sigint_cb)
    except ValueError:
        pass  # not in main thread (e.g. under a test runner)


def stats():
    ''' live scanning statistics (same keys as kvarq_tpu.engine.stats) '''
    longest = min(_stats.rls_longest, reader.MAX_READLENGTH - 1)
    rls = tuple(int(x) for x in _stats.rls[:longest + 1])
    progress = 0.0
    if _stats.total > 0:
        progress = float(min(_stats.parsed, _stats.total)) / _stats.total
    return {
        'readlengths': rls,
        'progress': progress,
        'nseqbasehits': tuple(int(x) for x in _seqbasehits),
        'nseqhits': tuple(int(x) for x in _seqhits),
        'parsed': int(_stats.parsed),
        'total': int(_stats.total),
        'sigints': _sigints,
        'records_parsed': int(_stats.records_parsed),
    }


@functools.lru_cache(maxsize=4)
def _cached_sieve(seqs_key, maxerrors, minoverlap, minreadlength):
    from kvarq_tpu.engine.sieve import KmerSieve
    return KmerSieve.build(list(seqs_key), maxerrors, minoverlap,
                           minreadlength)


def _make_sieve(seqs):
    mode = _extra_config['sieve']
    if mode in (False, 'off', '0', 'no'):
        return None
    sieve = _cached_sieve(tuple(seqs), _config['maxerrors'],
                          _config['minoverlap'], _config['minreadlength'])
    if sieve is None and mode != 'auto':
        lo.warning('k-mer sieve not applicable for current config; disabled')
    return sieve


def countseqs(fname, seqs):
    '''
    tensorized scan: accumulates per-template base counts on the device
    (no hit list).  Statistics are those of ``kvarq_tpu.engine.findseqs``;
    :py:func:`kvarq_tpu.engine.tensor_scan.fold_into_coverage` maps the
    base counts onto :py:class:`~kvarq_tpu.analyse.Coverage` objects.

    :returns: dict with ``basecounts`` (list of [5, S] int64 arrays in
        scanned-strand coordinates, parallel to ``seqs``) and ``stats``
    '''
    global _running, _stop, _sigints, _stats, _seqhits, _seqbasehits

    from kvarq_tpu.fastq import FastqFileFormatException
    from kvarq_tpu_torch import device
    from kvarq_tpu_torch.engine.tensor_scan import TensorScanner

    with _lock:
        if _running:
            raise RuntimeError('countseqs() already running!')
        _running = True
    _stop = False
    _sigints = 0

    try:
        fnames = [fname] if isinstance(fname, str) else list(fname)
        seqs = list(seqs)
        _seqhits = np.zeros(len(seqs), dtype=np.int64)
        _seqbasehits = np.zeros(len(seqs), dtype=np.int64)
        _stats = reader.ReaderStats()

        scanner = TensorScanner(
            seqs, _config['maxerrors'], _config['minoverlap'],
            device.select(_extra_config['device'])) if seqs else None
        sieve = _make_sieve(seqs) if seqs else None
        if sieve is not None:
            # sieve-fed batches hold only candidate reads: start dense
            scanner.assume_dense()

        try:
            for batch in reader.prefetch(reader.batches(
                    fnames, ord(_config['Amin']), _config['minreadlength'],
                    _stats, batchsize=_extra_config['batchsize'],
                    stop_check=lambda: _stop, sieve=sieve,
                    nthreads=_config['nthreads'])):
                if scanner is None:
                    continue
                scanner.scan_batch(batch)
                # live counters for stats() polling during the scan
                _seqhits[:] = scanner.seqhits
                _seqbasehits[:] = scanner.seqbasehits
        except reader.FastqFormatError as e:
            raise FastqFileFormatException(str(e))

        if scanner is not None:
            scanner.finalize()
            _seqhits[:] = scanner.seqhits
            _seqbasehits[:] = scanner.seqbasehits
            basecounts = scanner.coverages()
        else:
            basecounts = []
        return {
            'basecounts': basecounts,
            'stats': stats(),
        }
    finally:
        _running = False
