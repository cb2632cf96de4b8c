'''
Scan-engine API of the port (counterpart of kvarq_tpu/engine/__init__.py):
:py:data:`Hit`, :py:func:`config` / :py:func:`get_config`,
:py:func:`stats`, :py:func:`stop`, :py:func:`install_sigint_counter`, the
coverage scan :py:func:`countseqs` and the hit-list scan
:py:func:`findseqs`.  The module keeps its own configuration and scan
state.

The host input pipeline is the port's copy of kvarq_tpu's: the native
C++ reader (:py:mod:`~kvarq_tpu_torch.engine.reader`,
:py:mod:`~kvarq_tpu_torch.engine.native`) and the k-mer sieve
(:py:mod:`~kvarq_tpu_torch.engine.sieve`).  The device steps are
:py:class:`kvarq_tpu_torch.engine.tensor_scan.TensorScanner` (coverage)
and the matchers of :py:mod:`kvarq_tpu_torch.engine.match_pallas` (on
the card: candidate screen, compaction, then the exact extraction H1) and
:py:mod:`kvarq_tpu_torch.engine.match_xla` (on the CPU: exact extraction
alone); with a ``mesh`` configured, their sharded counterparts in
:py:mod:`kvarq_tpu_torch.parallel`.

The ``backend`` key picks the path.  ``device`` (the default) runs on the
configured ``device``.  ``numpy`` runs the byte-exact
:py:class:`~kvarq_tpu_torch.engine.match_numpy.NumpyMatcher` on the host
(``countseqs`` folds its hit list into base counts) and ignores a mesh.
``auto`` takes the numpy path for a small input while CUDA is still cold
(:py:func:`_small_scan_eligible`) and the device path otherwise.  Unlike
kvarq_tpu, where ``auto`` is the default, the port's default never leaves
the configured device: ``auto`` is asked for, by ``KVARQ_BACKEND=auto``
or ``engine.config(backend='auto')``.
'''

import collections
import contextlib
import functools
import os
import stat
import sys
import threading

import numpy as np

from kvarq_tpu_torch.engine import encode, reader
from kvarq_tpu_torch.log import lo
from kvarq_tpu_torch.profiling import span

Hit = collections.namedtuple(
    'Hit', 'seq_nr file_pos seq_pos length readlength')
Hit.__doc__ += (
    '''
seq_nr : refers to the list of sequences in call to engine.findseqs
file_pos : beginning of read (within decompressed data)
seq_pos : places the beginning of the read relative to the beginning of
    the sequence (<0 if read overlaps only with beginning of sequence or
    read contains whole sequence; >0 if read overlaps only with end of
    sequence or read is contained within sequence)
length : gives the number of overlapping basepairs
readlength : length of the (quality trimmed) read containing the hit
''')

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
    # $KVARQ_BACKEND where it names numpy or auto; its device names (the
    # CLI's cuda, cpu) leave the choice to ``device``
    'backend': {'numpy': 'numpy', 'auto': 'auto'}.get(
        os.environ.get('KVARQ_BACKEND'), 'device'),
    'device': 'cuda',
    'batchsize': int(os.environ.get('KVARQ_BATCHSIZE', '16384')),
    'sieve': os.environ.get('KVARQ_SIEVE', 'auto'),
    'mesh': os.environ.get('KVARQ_MESH', ''),
}

# the values of the ``backend`` key, and kvarq_tpu's other backend names
# with the port's counterparts
BACKENDS = ('device', 'numpy', 'auto')
_COUNTERPARTS = {'xla': "device 'cpu' (the device path with no screen "
                        "kernel)",
                 'pallas': "device 'cuda' (the device path with the CUDA "
                           "candidate screen)"}

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
        ``backend`` (``device``, ``numpy`` or ``auto``; see the module's
        docstring), ``device`` (a torch device string), ``batchsize``,
        ``sieve`` and ``mesh`` (a spec for
        :py:func:`kvarq_tpu_torch.parallel.parse_mesh` on ``device``, or a
        :py:class:`~kvarq_tpu_torch.parallel.Mesh`; empty: one device) '''
    for key, value in kwargs.items():
        if key in ('Amin', 'Azero'):
            if not isinstance(value, str) or len(value) != 1:
                raise TypeError('%s must be a single character' % key)
            _config[key] = value
        elif key in ('maxerrors', 'minoverlap', 'minreadlength', 'nthreads'):
            _config[key] = int(value)
        elif key == 'backend' and value not in BACKENDS:
            raise TypeError('backend must be one of %s%s' % (
                ', '.join(BACKENDS), "; kvarq_tpu's %s is the port's "
                "backend 'device' with %s" % (value, _COUNTERPARTS[value])
                if value in _COUNTERPARTS else ''))
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
    from kvarq_tpu_torch.engine.sieve import KmerSieve
    return KmerSieve.build(list(seqs_key), maxerrors, minoverlap,
                           minreadlength)


def _make_sieve(seqs):
    mode = _extra_config['sieve']
    if mode in (False, 'off', '0', 'no'):
        return None
    # built sieves are cached (a pure function of the arguments, immutable
    # after the build): repeated scans of one bank reuse the index
    sieve = _cached_sieve(tuple(seqs), _config['maxerrors'],
                          _config['minoverlap'], _config['minreadlength'])
    if sieve is None and mode != 'auto':
        lo.warning('k-mer sieve not applicable for current config; disabled')
    return sieve


@contextlib.contextmanager
def _scan(name, nseqs):
    ''' one scan at a time: resets the scan state that :py:func:`stats`
        reports, for ``nseqs`` templates '''
    global _running, _stop, _sigints, _stats, _seqhits, _seqbasehits
    with _lock:
        if _running:
            raise RuntimeError('%s() already running!' % name)
        # the new scan's state first: a poll of stats() that sees
        # ``_running`` never reads the previous scan's progress
        _stop = False
        _sigints = 0
        _seqhits = np.zeros(nseqs, dtype=np.int64)
        _seqbasehits = np.zeros(nseqs, dtype=np.int64)
        _stats = reader.ReaderStats()
        _running = True
    try:
        yield
    finally:
        _running = False


def _batches(fnames, sieve, raw):
    ''' the shared reader's batches under the current configuration,
        with the reads' bytes where ``raw``; malformed input raises
        FastqFileFormatException '''
    from kvarq_tpu_torch.fastq import FastqFileFormatException
    try:
        yield from reader.prefetch(reader.batches(
            fnames, ord(_config['Amin']), _config['minreadlength'], _stats,
            batchsize=_extra_config['batchsize'],
            stop_check=lambda: _stop, sieve=sieve,
            nthreads=_config['nthreads'], raw=raw))
    except reader.FastqFormatError as e:
        raise FastqFileFormatException(str(e))


def _mesh_requested():
    ''' True when the ``mesh`` key names a mesh (a spec or a Mesh) '''
    spec = _extra_config['mesh']
    if spec and not isinstance(spec, str):
        return True
    return str(spec or '').strip().lower() not in ('', 'off', '0', 'no',
                                                   'none')


def _mesh():
    ''' the configured mesh, None for the single-device scan '''
    from kvarq_tpu_torch import parallel
    spec = _extra_config['mesh']
    if isinstance(spec, parallel.Mesh):
        return spec
    if not _mesh_requested():
        return None
    spec = str(spec).strip().lower()
    mesh = parallel.parse_mesh(spec, _extra_config['device'])
    lo.info('scanning over %s' % mesh)
    return mesh


def _make_scanner(seqs):
    ''' the single-device TensorScanner, or a ShardedScanner when a mesh
        is configured '''
    from kvarq_tpu_torch import device
    mesh = _mesh()
    if mesh is not None:
        from kvarq_tpu_torch.parallel import ShardedScanner
        return ShardedScanner(seqs, _config['maxerrors'],
                              _config['minoverlap'], mesh)
    from kvarq_tpu_torch.engine.tensor_scan import TensorScanner
    return TensorScanner(seqs, _config['maxerrors'], _config['minoverlap'],
                         device.select(_extra_config['device']))


def countseqs(fname, seqs):
    '''
    tensorized scan: accumulates per-template base counts on the device
    (no hit list).  Statistics are those of :py:func:`findseqs`;
    :py:func:`kvarq_tpu_torch.engine.encode.fold_into_coverage` maps
    the base counts onto :py:class:`~kvarq_tpu_torch.analyse.Coverage`
    objects.  On the numpy path (the ``backend`` key) the base counts are
    those of the numpy hit list (:py:func:`_basecounts_from_hits`).

    :returns: dict with ``basecounts`` (list of [5, S] int64 arrays in
        scanned-strand coordinates, parallel to ``seqs``) and ``stats``
    '''
    fnames = [fname] if isinstance(fname, str) else list(fname)
    seqs = list(seqs)
    with _scan('countseqs', len(seqs)):
        if seqs and _numpy_path(fnames):
            hits, hitseqs = _hits(fnames, seqs, True)
            return {
                'basecounts': _basecounts_from_hits(hits, hitseqs, seqs),
                'stats': stats(),
            }
        with span('engine.bank'):
            scanner = _make_scanner(seqs) if seqs else None
            sieve = _make_sieve(seqs) if seqs else None
            if sieve is not None:
                # sieve-fed batches hold only candidate reads: start dense
                scanner.assume_dense()

        # the scanners read the codes alone
        for batch in _batches(fnames, sieve, raw=False):
            if scanner is None:
                continue
            with span('engine.scan'):
                scanner.scan_batch(batch)
            # live counters for stats() polling during the scan
            _seqhits[:] = scanner.seqhits
            _seqbasehits[:] = scanner.seqbasehits

        if scanner is not None:
            with span('engine.scan'):
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


def _basecounts_from_hits(hits, hitseqs, seqs):
    ''' per-template [5, S] base counts in scanned-strand coordinates from
        a hit list -- the quantity the device path accumulates (non-AGCTN
        read bytes are dropped, as the device path's 5-channel one-hot
        drops them) '''
    counts = [np.zeros((encode.NBASE, len(s)), np.int64) for s in seqs]
    for hit, hitseq in zip(hits, hitseqs):
        start = max(0, hit.seq_pos)
        codes = encode.encode_read(hitseq.encode('latin-1'))
        pos = start + np.arange(len(codes))
        valid = codes < encode.NBASE
        np.add.at(counts[hit.seq_nr], (codes[valid], pos[valid]), 1)
    return counts


def _matcher_on(dev, seqs, maxerrors, minoverlap):
    ''' the screening matcher on a CUDA device (every batch through the
        candidate screen), exact extraction alone on the CPU '''
    if dev.type == 'cuda':
        from kvarq_tpu_torch.engine.match_pallas import PallasMatcher
        return PallasMatcher(seqs, maxerrors, minoverlap, dev)
    from kvarq_tpu_torch.engine.match_xla import XlaMatcher
    return XlaMatcher(seqs, maxerrors, minoverlap, dev)


def _make_matcher(seqs):
    ''' the matcher of the configured device (:py:func:`_matcher_on`);
        with a mesh configured, the sharded screen over the mesh '''
    from kvarq_tpu_torch import device
    mesh = _mesh()
    if mesh is not None:
        from kvarq_tpu_torch.parallel import ShardedMatcher
        return ShardedMatcher(seqs, _config['maxerrors'],
                              _config['minoverlap'], mesh)
    return _matcher_on(device.select(_extra_config['device']), seqs,
                       _config['maxerrors'], _config['minoverlap'])


def findseqs(fname, seqs):
    '''
    scan fastq file(s) for template base sequences (the counterpart of
    ``kvarq_tpu.engine.findseqs``, with the same hits in the same order).

    :param fname: filename or sequence of filenames
    :param seqs: list of template base strings
    :returns: dict with ``hits`` (tuple of :py:data:`Hit`), ``stats`` (as
        :py:func:`stats`), ``hitseqs`` (list of matched read base strings,
        parallel to ``hits``)
    '''
    fnames = [fname] if isinstance(fname, str) else list(fname)
    seqs = list(seqs)
    with _scan('findseqs', len(seqs)):
        hits, hitseqs = _hits(fnames, seqs,
                              bool(seqs) and _numpy_path(fnames))
        return {
            'hits': tuple(hits),
            'stats': stats(),
            'hitseqs': hitseqs,
        }


def _hits(fnames, seqs, numpy_path):
    ''' the hit list and hit sequences of the running scan, on the numpy
        path or the device's '''
    with span('engine.bank'):
        if not seqs:
            matcher = None
        elif numpy_path:
            from kvarq_tpu_torch.engine.match_numpy import NumpyMatcher
            matcher = NumpyMatcher(seqs, _config['maxerrors'],
                                   _config['minoverlap'])
        else:
            matcher = _make_matcher(seqs)
        sieve = _make_sieve(seqs) if seqs else None
    seqlens = [len(s) for s in seqs]
    hits = []
    hitseqs = []
    for batch in _batches(fnames, sieve, raw=True):
        if matcher is None:
            continue
        with span('engine.match'):
            triplets = matcher.match_batch(batch)
        with span('engine.emit'):
            _emit(triplets, batch, seqlens, _config['minoverlap'], hits,
                  hitseqs, _seqhits, _seqbasehits)
    return hits, hitseqs


def _numpy_path(fnames):
    ''' True when the running scan takes the host's numpy path: the
        ``numpy`` backend, or ``auto`` on a small input while CUDA is cold
        (:py:func:`_small_scan_eligible`) '''
    backend = _extra_config['backend']
    if backend == 'numpy':
        return True
    if backend == 'auto':
        if _small_scan_eligible(fnames):
            lo.debug('small input: scanning via the numpy hit path')
            return True
        lo.debug('backend auto: scanning on %s' % _extra_config['device'])
    return False


def _cuda_ready():
    ''' True iff this process has initialised CUDA (the counterpart of
        kvarq_tpu's ``_jax_device_ready``), without initialising it '''
    torch = sys.modules.get('torch')
    return torch is not None and torch.cuda.is_initialized()


# inputs smaller than this (decompressed-size estimate) take the numpy hit
# path under backend 'auto' while CUDA is cold: a CUDA context and the
# kernel's load cost more than a numpy scan of a few thousand reads.  0
# disables it; it never engages for another backend, with a mesh, or once
# this process has initialised CUDA.
SMALL_SCAN_BYTES = int(os.environ.get('KVARQ_SMALL_SCAN', '4000000'))


def _small_scan_eligible(fnames):
    ''' a copy of kvarq_tpu's, keyed off CUDA initialisation.  kvarq_tpu's
        ``KVARQ_TENSOR_BACKEND`` clause is left out: the port has no such
        variable. '''
    if SMALL_SCAN_BYTES <= 0:
        return False
    if _extra_config['backend'] != 'auto':
        return False
    if _mesh_requested() or _cuda_ready():
        return False
    try:
        # size estimate: gzip detected by magic bytes (so .bgz/.bgzf
        # inputs count too), at a conservative 8x -- a tens-of-MB
        # decompressed input must not take the numpy path
        total = 0
        for f in fnames:
            # regular files only: sniffing the magic of a FIFO would
            # consume bytes that the reader needs
            if not stat.S_ISREG(os.stat(f).st_mode):
                return False
            size = os.path.getsize(f)
            with open(f, 'rb') as fd:
                if fd.read(2) == b'\x1f\x8b':
                    size *= 8
            total += size
    except OSError:
        return False
    return total < SMALL_SCAN_BYTES


def _emit(triplets, batch, seqlens, mo, hits, hitseqs, seqhits,
          seqbasehits):
    ''' convert passing (read, template, shift) triplets into Hit tuples in
        the reference's single-threaded enumeration order (record, then
        template, then mode A desc / B desc / C-or-D asc -- see
        kvarq_tpu.engine.hitmodel), appending to ``hits``/``hitseqs`` and
        adding into the per-template ``seqhits``/``seqbasehits``.

        A copy of ``kvarq_tpu.engine._emit`` that takes the accumulators
        as arguments: that one adds into kvarq_tpu.engine's own module
        state. '''
    if not len(triplets):
        return
    trip = np.unique(np.asarray(triplets, dtype=np.int64), axis=0)
    b, t, d = trip[:, 0], trip[:, 1], trip[:, 2]
    rl = batch.rl.astype(np.int64)[b]
    seql = np.asarray(seqlens, dtype=np.int64)[t]

    # one candidate emission per (triplet, mode); B and D can both fire at
    # the same shift (the reference's mode-B/D border duplicate)
    ab = (rl > mo) & (seql > mo)
    emits = []   # (mask, rank, intra-mode order key, length)
    # mode A (read tail over template head): i=-d desc  ->  d asc
    mask = ab & (d < 0) & (-d >= np.maximum(1, rl - seql + 1)) \
        & (-d <= rl - mo)
    emits.append((mask, 0, d, rl + d))
    # mode B (read head over template tail): i=d desc  ->  d desc
    mask = ab & (d > 0) & (d >= np.maximum(1, seql - rl)) \
        & (d <= seql - mo)
    emits.append((mask, 1, -d, seql - d))
    # mode C (template within read): i=-d asc  ->  d desc
    mask = (rl > seql) & (d <= 0) & (-d <= rl - seql)
    emits.append((mask, 2, -d, seql.copy()))
    # mode D (read within template): i=d asc  ->  d asc
    mask = (rl <= seql) & (d >= 0) & (d <= seql - rl)
    emits.append((mask, 2, d, rl.copy()))

    idx = np.concatenate([np.flatnonzero(m) for m, _, _, _ in emits])
    rank = np.concatenate([np.full(int(m.sum()), r, dtype=np.int8)
                           for m, r, _, _ in emits])
    key = np.concatenate([k[m] for m, _, k, _ in emits])
    length = np.concatenate([ln[m] for m, _, _, ln in emits])
    if not len(idx):
        return
    order = np.lexsort((key, rank, t[idx], b[idx]))
    idx, length = idx[order], length[order]
    eb, et, ed = b[idx], t[idx], d[idx]
    erl, efp = rl[idx], batch.filepos.astype(np.int64)[eb]
    start = np.maximum(0, -ed)

    np.add.at(seqhits, et, 1)
    np.add.at(seqbasehits, et, length)

    raw = batch.raw
    for i in range(len(idx)):
        hits.append(Hit(seq_nr=int(et[i]), file_pos=int(efp[i]),
                        seq_pos=int(ed[i]), length=int(length[i]),
                        readlength=int(erl[i])))
        s = start[i]
        hitseqs.append(
            raw[eb[i], s:s + length[i]].tobytes().decode('latin-1'))
