'''
Host-side FastQ input pipeline: streams one or more plain/gzipped FastQ
files as a single decompressed byte stream, parses records, quality-trims
each read and yields fixed-shape batches ready for the device matchers.

Replaces the reference's mutex-shared chunked reader + per-record parse/trim
(csrc/workhorse.c:737-956, :1010-1103) with a vectorized numpy parser.
Error messages and edge-case behavior (partial trailing records dropped,
``@``/``+`` sanity checks with global decompressed offsets, first-longest
quality run wins) replicate the C engine exactly.

An optional C++ implementation (csrc/) with the same interface can be used
as a drop-in accelerator; see kvarq_tpu_torch.engine.native.
'''

import gzip
import os

import numpy as np

from kvarq_tpu_torch.engine import encode
from kvarq_tpu_torch.profiling import span

CHUNKSIZE = 8 * 1024 * 1024
MAX_READLENGTH = 1024  # histogram cap (workhorse.c:105)


class ReaderStats:
    ''' live counters updated while streaming (thread-safe enough for the
        1 Hz/10 Hz polling done by CLI/GUI: plain attribute stores) '''

    def __init__(self):
        self.rls = np.zeros(MAX_READLENGTH, dtype=np.int64)
        self.rls_longest = -1
        self.records_parsed = 0
        self.parsed = 0          # decompressed bytes consumed
        self.total = 0           # (estimated) total decompressed bytes


class RecordBatch:
    '''
    a batch of quality-trimmed reads in fixed-shape arrays:

    - ``codes``: uint8 [B, Lpad] encoded trimmed reads, padded with
      :py:data:`encode.CODE_READ_JUNK`
    - ``rl``: int32 [B] trimmed read lengths (all >= minreadlength)
    - ``filepos``: int64 [B] global decompressed offset of the trimmed
      read start (the reference's ``Hit.file_pos``)
    - ``raw``: uint8 [B, Lpad] raw trimmed read bytes, padded with 0 (for
      hitseqs), or None where the batches were read without them
    '''

    __slots__ = ('codes', 'rl', 'filepos', 'raw')

    def __init__(self, codes, rl, filepos, raw):
        self.codes = codes
        self.rl = rl
        self.filepos = filepos
        self.raw = raw

    def __len__(self):
        return self.codes.shape[0]


class FastqFormatError(Exception):
    ''' translated to kvarq_tpu_torch.fastq.FastqFileFormatException by the engine '''


def _open_stream(fname):
    if fname.endswith('.gz'):
        raw = open(fname, 'rb')
        return gzip.GzipFile(fileobj=raw), raw, True
    f = open(fname, 'rb')
    return f, f, False


def stream_chunks(fnames, stats):
    '''
    generator yielding ``(chunk_bytes, global_offset)`` of decompressed,
    record-boundary-*unaligned* raw data; updates ``stats.parsed`` /
    ``stats.total`` while streaming.  Offsets continue across files
    (workhorse.c fastq_file.fpos semantics).
    '''
    # initial size estimate: plain size, or 3x compressed (workhorse.c:624-626)
    sizes = [os.path.getsize(f) for f in fnames]
    est = [s * 3 if f.endswith('.gz') else s for f, s in zip(fnames, sizes)]
    stats.total = sum(est)

    offset = 0
    for fi, fname in enumerate(fnames):
        f, raw, is_gz = _open_stream(fname)
        produced = 0
        try:
            while True:
                data = f.read(CHUNKSIZE)
                if not data:
                    break
                yield data, offset
                offset += len(data)
                produced += len(data)
                stats.parsed = offset
                if is_gz:
                    # refine decompressed-size estimate from compression
                    # ratio so far (workhorse.c:882-884)
                    frac = min(1.0, max(raw.tell(), 1) / max(sizes[fi], 1))
                    est[fi] = max(produced, int(produced / max(frac, 1e-9)))
                    stats.total = sum(est)
        finally:
            f.close()
        est[fi] = produced  # exact once the file is fully read
        stats.total = sum(est)
    stats.parsed = offset
    stats.total = offset if offset else stats.total


def parse_records(buf, global_offset, Amin, stats, at_eof):
    '''
    parse complete 4-line records from ``buf`` (bytes); returns
    ``(recs, leftover)`` where ``recs`` is a dict of numpy arrays
    (bases_start, qual_start, qual_stop, trim_off, rl) with *buffer-local*
    offsets, and ``leftover`` the trailing partial record (b'' at EOF).

    Replicates workhorse.c:1010-1103: a record needs 4 newlines (else the
    tail is dropped silently at EOF), must start with ``@`` and have ``+``
    on line 3 (exact error messages with global fpos), quality runs are
    broken by any byte < Amin (including CR/LF).
    '''
    a = np.frombuffer(buf, dtype=np.uint8)
    nl = np.flatnonzero(a == 0x0A)
    nrec = len(nl) // 4

    if nrec == 0:
        if at_eof:
            return None, b''
        return None, buf

    last_complete_end = nl[4 * nrec - 1] + 1
    leftover = buf[last_complete_end:]
    if at_eof and len(leftover):
        # trailing data without 4 newlines is silently dropped (C engine
        # breaks out of the record loop at lines<4, workhorse.c:1032-1034)
        # -- unless it contains a full record, which the caller prevents.
        leftover = b''

    line_starts = np.empty(4 * nrec, dtype=np.int64)
    line_starts[0] = 0
    line_starts[1:] = nl[:4 * nrec - 1] + 1

    rec_starts = line_starts[0::4]
    bases_start = line_starts[1::4]
    plus_start = line_starts[2::4]
    qual_start = line_starts[3::4]
    qual_stop = nl[3::4][:nrec]  # position of the '\n' ending the quality line

    bad = a[rec_starts] != ord('@')
    if bad.any():
        i = int(np.argmax(bad))
        fpos = global_offset + int(rec_starts[i])
        ch = chr(int(a[rec_starts[i]]))
        raise FastqFormatError(
            "record must start with '@' (and not '%c') fpos=%ld" % (ch, fpos))
    bad = a[plus_start] != ord('+')
    if bad.any():
        i = int(np.argmax(bad))
        fpos = global_offset + int(plus_start[i])
        raise FastqFormatError(
            "3rd line of record must start with '+' fpos=%ld" % fpos)

    # --- vectorized quality trim: longest run of bytes >= Amin within each
    # quality line, first-longest wins (workhorse.c:1055-1070)
    m = a >= Amin
    # restrict to quality-line spans
    delta = np.zeros(len(a) + 1, dtype=np.int8)
    delta[qual_start] = 1
    delta[qual_stop] -= 1
    inq = np.cumsum(delta[:-1]).astype(bool)
    m &= inq

    mi = m.astype(np.int8)
    d = np.diff(mi, prepend=np.int8(0), append=np.int8(0))
    run_starts = np.flatnonzero(d == 1)
    run_ends = np.flatnonzero(d == -1)
    run_lens = run_ends - run_starts

    rl = np.zeros(nrec, dtype=np.int32)
    trim_off = np.zeros(nrec, dtype=np.int64)
    if len(run_starts):
        run_rec = np.searchsorted(qual_start, run_starts, side='right') - 1
        # first-longest per record: sort by (record, -length, position)
        order = np.lexsort((run_starts, -run_lens, run_rec))
        rec_sorted = run_rec[order]
        first = np.ones(len(order), dtype=bool)
        first[1:] = rec_sorted[1:] != rec_sorted[:-1]
        sel = order[first]
        rec_ids = run_rec[sel]
        rl[rec_ids] = run_lens[sel].astype(np.int32)
        trim_off[rec_ids] = run_starts[sel] - qual_start[rec_ids]

    # histogram over *all* records incl. rl=0 / too-short (workhorse.c:1069)
    np.add.at(stats.rls, np.minimum(rl, MAX_READLENGTH - 1), 1)
    longest = int(rl.max()) if nrec else -1
    if longest > stats.rls_longest:
        stats.rls_longest = longest
    stats.records_parsed += nrec

    recs = dict(
        bases_start=bases_start,
        trim_off=trim_off,
        rl=rl,
    )
    return recs, leftover


def batches(fnames, Amin, minreadlength, stats, batchsize=4096,
            stop_check=None, sieve=None, nthreads=1, raw=True):
    '''
    generator over :py:class:`RecordBatch` es for the given files.

    :param Amin: quality cutoff as integer ASCII value
    :param stop_check: optional callable; when it returns True the stream
        ends early (engine.stop() semantics, workhorse.c:999)
    :param sieve: optional :py:class:`kvarq_tpu_torch.engine.sieve.KmerSieve`;
        provably hit-free reads are dropped before batching (statistics
        still count every parsed record).  In the native pipeline the
        filter runs inside the C parse loop, so batches stay full of
        candidate reads; here it subsets each built batch (slower, the
        byte-exact oracle).
    :param nthreads: native-pipeline parse/trim/sieve worker threads
        (reference ``nthreads``, workhorse.c:74); output is deterministic
        regardless.  The numpy fallback ignores it.
    :param raw: the batches carry the reads' bytes (``raw``); without it
        ``raw`` is None, for callers that read the codes alone

    Dispatches to the native C++ pipeline (csrc/reader.cpp) when it is
    available; the numpy implementation below is the byte-exact fallback
    and test oracle.  ``KVARQ_NATIVE=0`` forces the fallback.
    '''
    if os.environ.get('KVARQ_NATIVE', '1') != '0':
        from kvarq_tpu_torch.engine import native
        if native.available():
            yield from native.batches(fnames, Amin, minreadlength, stats,
                                      batchsize, stop_check, sieve,
                                      nthreads, raw)
            return
    if sieve is not None:
        for batch in batches(fnames, Amin, minreadlength, stats,
                             batchsize, stop_check, raw=raw):
            sel = sieve.candidates(batch)
            if sel is None:
                yield batch
            elif len(sel):
                yield RecordBatch(
                    batch.codes[sel], batch.rl[sel], batch.filepos[sel],
                    None if batch.raw is None else batch.raw[sel])
        return

    pend = []   # list of (rl int, filepos int, raw bytes) per read, in order

    def make_batch(items):
        rl = np.array([it[0] for it in items], dtype=np.int32)
        fp = np.array([it[1] for it in items], dtype=np.int64)
        Lpad = _round_up(int(rl.max()))
        B = len(items)
        # pad with NUL -- never equal to any template byte, so padding can
        # never be counted as a match by the byte-exact golden matcher
        rows = np.zeros((B, Lpad), dtype=np.uint8)
        for i, it in enumerate(items):
            rows[i, :it[0]] = np.frombuffer(it[2], dtype=np.uint8)
        codes = encode.encode_read_array(rows)
        codes[np.arange(Lpad)[None, :] >= rl[:, None]] = encode.CODE_READ_JUNK
        return RecordBatch(codes, rl, fp, rows if raw else None)

    def flush(force=False):
        nonlocal pend
        while len(pend) >= batchsize or (force and pend):
            items, pend = pend[:batchsize], pend[batchsize:]
            yield make_batch(items)

    leftover = b''
    leftover_offset = 0
    stream = stream_chunks(fnames, stats)
    chunk_iter = iter(stream)
    done = False
    while not done:
        if stop_check is not None and stop_check():
            break
        try:
            data, offset = next(chunk_iter)
        except StopIteration:
            data, offset = b'', leftover_offset + len(leftover)
            done = True
        if leftover:
            buf = leftover + data
            buf_offset = leftover_offset
        else:
            buf = data
            buf_offset = offset
        if not buf:
            break

        recs, leftover = parse_records(buf, buf_offset, Amin, stats,
                                       at_eof=done)
        leftover_offset = buf_offset + len(buf) - len(leftover)
        if recs is None:
            continue

        keep = recs['rl'] >= minreadlength
        if minreadlength <= 0:
            # rl==0 records have undefined trim offsets in the reference
            # (uninitialized pointer, workhorse.c:1064/1070); we skip them
            keep &= recs['rl'] > 0
        if keep.any():
            rl = recs['rl'][keep]
            start = recs['bases_start'][keep] + recs['trim_off'][keep]
            fp = buf_offset + start
            for s, l, p in zip(start, rl, fp):
                pend.append((int(l), int(p), buf[s:s + l]))
            yield from flush()

    yield from flush(force=True)


def prefetch(iterator, depth=2):
    '''
    run ``iterator`` on a background thread, keeping up to ``depth``
    items ready -- overlaps host-side parsing with device dispatch (the
    reference overlaps I/O and scanning with its pthread fan-out,
    workhorse.c:1375-1408; here one reader thread feeds the accelerator).
    Exceptions re-raise at the consumer; the thread stops when the
    consumer abandons the generator.
    '''
    import queue
    import threading

    q = queue.Queue(maxsize=depth)
    _END = object()
    abandoned = threading.Event()

    def worker():
        try:
            for item in iterator:
                while not abandoned.is_set():
                    try:
                        q.put(item, timeout=0.2)
                        break
                    except queue.Full:
                        continue
                if abandoned.is_set():
                    return
            q.put(_END)
        except BaseException as e:   # noqa: B036 -- re-raised below
            q.put(e)

    t = threading.Thread(target=worker, daemon=True,
                         name='kvarq-reader-prefetch')
    t.start()
    try:
        while True:
            with span('engine.wait'):
                item = q.get()
            if item is _END:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        abandoned.set()


def _round_up(n):
    ''' pad read length to a small set of static shapes to bound the number
        of compiled kernel variants; the native reader's rows take the
        same widths from ``round_up`` in csrc/reader.cpp, which sets both
        a batch's width and the wider rows after its -2 return '''
    for cap in (64, 128, 192, 256, 384, 512, 768, 1024):
        if n <= cap:
            return cap
    return ((n + 127) // 128) * 128
