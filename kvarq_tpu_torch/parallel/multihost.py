'''
Multi-process scale-out of the port (counterpart of
kvarq_tpu/parallel/multihost.py): a corpus of FastQ files scanned by
several processes -- one per host, or several on one host -- each driving
its own local mesh over its own shard of the files.  By default a
process's mesh holds its share of its host's cards
(:py:func:`local_cards`): the processes of one host split the cards
between them, and share one when they outnumber the cards.

Usage (run the SAME program in every process):

    from kvarq_tpu_torch.parallel import multihost
    multihost.initialize()        # KVARQ_COORDINATOR=host:port,
                                  # KVARQ_NUM_PROCESSES, KVARQ_PROCESS_ID
    covs, seqhits, seqbasehits = multihost.scan_sharded(
        fnames, seqs, maxerrors=2, minoverlap=25, minreadlength=25,
        Amin=chr(33 + 13))

Collective contract: the processes exchange host int64 tensors over a
Gloo process group (``torch.distributed``), a few MB per scan and never
per step.  A process scans its whole shard locally and the results merge
once at the end (integer sums, so bitwise equal to a per-step merge).
Every process enters the same collectives in the same order whether its
shard is empty or not, so no process ever blocks alone in a collective,
and the JAX package's per-step all-hosts vote is not needed.  With one
process (no group) every collective is skipped.
'''

import atexit
import os
import socket

import numpy as np

from kvarq_tpu_torch.engine import encode, reader
from kvarq_tpu_torch.log import lo
from kvarq_tpu_torch.parallel import ShardedScanner, make_mesh


def initialize(**kwargs):
    ''' join the Gloo process group and return ``(rank, world_size)``.
        Arguments as the JAX package's (``coordinator_address='host:port'``,
        ``num_processes=``, ``process_id=``), or the environment
        variables ``KVARQ_COORDINATOR`` / ``KVARQ_NUM_PROCESSES`` /
        ``KVARQ_PROCESS_ID``; with neither, ``(0, 1)`` and no group.  A
        group that exists already is kept.  A group joined here is left
        (``destroy_process_group``) when the interpreter exits, before
        its objects are torn down. '''
    import torch.distributed as dist
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if not kwargs and os.environ.get('KVARQ_COORDINATOR'):
        kwargs = dict(
            coordinator_address=os.environ['KVARQ_COORDINATOR'],
            num_processes=int(os.environ['KVARQ_NUM_PROCESSES']),
            process_id=int(os.environ['KVARQ_PROCESS_ID']))
    if not kwargs:
        return 0, 1
    dist.init_process_group(
        'gloo', init_method='tcp://' + kwargs['coordinator_address'],
        world_size=int(kwargs['num_processes']),
        rank=int(kwargs['process_id']))
    atexit.register(_leave)
    lo.debug('process %d of %d joined %s' % (
        dist.get_rank(), dist.get_world_size(),
        kwargs['coordinator_address']))
    return dist.get_rank(), dist.get_world_size()


def _leave():
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


def _world():
    ''' ``(rank, world_size)`` of the process group, ``(0, 1)`` without '''
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _all_reduce(values, op='sum'):
    ''' elementwise sum (or max) of an int64 host array over every
        process '''
    import torch
    import torch.distributed as dist
    t = torch.from_numpy(np.array(values, dtype=np.int64))
    dist.all_reduce(t, op=dist.ReduceOp.SUM if op == 'sum'
                    else dist.ReduceOp.MAX)
    return t.numpy()


def _exchange(rows, blob):
    ''' every process's ``rows [n, k]`` int64 array and ``blob`` bytes, in
        rank order.  The counts go first, then each rank broadcasts only
        what it holds (nothing when it holds nothing: every process knows
        the counts, so all skip the same broadcasts). '''
    import torch
    import torch.distributed as dist
    rank, world = _world()
    mine = torch.tensor([len(rows), len(blob)], dtype=torch.int64)
    counts = [torch.zeros(2, dtype=torch.int64) for _ in range(world)]
    dist.all_gather(counts, mine)
    parts = []
    for p, (n, nb) in enumerate(c.tolist() for c in counts):
        if p == rank:
            r = torch.from_numpy(np.ascontiguousarray(rows, np.int64))
            b = torch.from_numpy(np.frombuffer(blob, np.uint8).copy())
        else:
            r = torch.empty((n, rows.shape[1]), dtype=torch.int64)
            b = torch.empty(nb, dtype=torch.uint8)
        if n:
            dist.broadcast(r, src=p)
        if nb:
            dist.broadcast(b, src=p)
        parts.append((r.numpy(), b.numpy().tobytes()))
    return parts


def _merge_stats(stats):
    ''' corpus-global reader stats in every process: histogram and
        counters summed, longest read the maximum '''
    summed = _all_reduce(np.concatenate([
        stats.rls.astype(np.int64),
        [stats.records_parsed, stats.parsed, stats.total]]))
    stats.rls = summed[:reader.MAX_READLENGTH]
    stats.records_parsed, stats.parsed, stats.total = \
        (int(x) for x in summed[-3:])
    stats.rls_longest = int(_all_reduce([stats.rls_longest], 'max')[0])


def shard_file_indices(fnames, process_id, num_processes):
    ''' deterministic per-process file assignment, balanced by file size
        (largest-first greedy); every process calls it with the same list.
        Indices into ``fnames``, so duplicate names stay distinct.  (The
        JAX package's copy imports jax to find the defaults.) '''
    sizes = [(os.path.getsize(f) if os.path.exists(f) else 0, i)
             for i, f in enumerate(fnames)]
    loads = [0] * num_processes
    mine = []
    for size, i in sorted(sizes, reverse=True):
        host = loads.index(min(loads))
        loads[host] += size
        if host == process_id:
            mine.append(i)
    return mine


def sample_max_readlen(fnames, n_records=4096):
    ''' max bases-line length over the first ``n_records`` records of each
        file -- a cheap per-host estimator for auto-sizing ``Lpad``
        (quality-trimmed reads are never longer than their bases line).
        Unreadable files contribute 0 (another host owns them).  (A copy of
        kvarq_tpu's.) '''
    import gzip
    mx = 0
    for fname in fnames:
        op = gzip.open if fname.endswith('.gz') else open
        try:
            with op(fname, 'rb') as f:
                for _ in range(n_records):
                    if not f.readline():        # identifier
                        break
                    bases = f.readline()
                    f.readline()                # separator
                    f.readline()                # quality
                    if not bases:
                        break
                    mx = max(mx, len(bases.rstrip(b'\r\n')))
        except OSError:
            pass
    return mx


def _host_share(k, m, ncards):
    ''' the card indices of local process ``k`` of the ``m`` processes of a
        host with ``ncards`` cards: balanced contiguous blocks, or one
        shared card each when the processes outnumber the cards '''
    if ncards >= m:
        return [c for c in range(ncards) if c * m // ncards == k]
    return [k * ncards // m]


def local_cards(ncards):
    ''' this process's share of its host's ``ncards`` cards: the processes
        with the same host name split them in rank order
        (:py:func:`_host_share`); a process alone keeps them all.  With a
        group this is a collective (the host names are gathered), so every
        process calls it. '''
    rank, world = _world()
    if world == 1:
        return list(range(ncards))
    import torch.distributed as dist
    names = [None] * world
    dist.all_gather_object(names, socket.gethostname())
    me = names[rank]
    return _host_share(names[:rank].count(me), names.count(me), ncards)


def local_mesh(device='cuda'):
    ''' a process's default mesh: its :py:func:`local_cards` on the data
        axis, or one ``cpu`` entry on the CPU '''
    import torch
    from kvarq_tpu_torch import device as _device
    if _device.select(device).type == 'cpu':
        return make_mesh(backend=device)
    return make_mesh(devices=[torch.device('cuda', c) for c in
                              local_cards(torch.cuda.device_count())])


def findseqs_sharded(fnames, seqs, maxerrors, minoverlap, minreadlength,
                     Amin, nthreads=8, stats=None, batchsize=16384,
                     device='cuda'):
    '''
    hit-list scan of a corpus sharded across processes (the ``findseqs``
    counterpart of :py:func:`scan_sharded`): every process scans its own
    files with a local matcher on ``device`` (on CUDA the first of its
    :py:func:`local_cards`, where the candidate screen runs), and each hit's ``file_pos`` is rebased into the global
    concatenated-stream coordinates that a single-process
    ``findseqs(fnames)`` reports: files are scanned one at a time, so each
    process knows its files' exact lengths; those sum into global
    per-file offsets.  The hits then go to every process (counts first,
    then only what each process holds) and merge in global file order,
    then in-file emission order.  ``stats`` ends up corpus-global.

    :returns: ``(hits, hitseqs)`` -- the contents of
        ``engine.findseqs(fnames, seqs)['hits'/'hitseqs']``
    '''
    from kvarq_tpu_torch.engine.sieve import KmerSieve
    from kvarq_tpu_torch.engine import Hit, _emit, _matcher_on

    rank, world = _world()
    fnames = list(fnames)
    # membership by INDEX: duplicate names are each scanned once
    mine = set(shard_file_indices(fnames, rank, world))
    seqs = list(seqs)
    matcher = _matcher_on(local_mesh(device).first, seqs, maxerrors,
                          minoverlap)
    sieve = KmerSieve.build(seqs, maxerrors, minoverlap, minreadlength)
    seqlens = [len(s) for s in seqs]
    seqhits = np.zeros(len(seqs), dtype=np.int64)
    seqbasehits = np.zeros(len(seqs), dtype=np.int64)
    stats = stats if stats is not None else reader.ReaderStats()

    flens = np.zeros(len(fnames), dtype=np.int64)
    per_file = []                     # (global file idx, hits, hitseqs)
    for i, fname in enumerate(fnames):
        if i not in mine:
            continue
        fstats = reader.ReaderStats()
        hits, hitseqs = [], []
        for batch in reader.prefetch(reader.batches(
                [fname], ord(Amin), minreadlength, fstats,
                batchsize=batchsize, sieve=sieve, nthreads=nthreads)):
            _emit(matcher.match_batch(batch), batch, seqlens, minoverlap,
                  hits, hitseqs, seqhits, seqbasehits)
        flens[i] = fstats.parsed      # exact decompressed length
        stats.records_parsed += fstats.records_parsed
        stats.parsed += fstats.parsed
        stats.total += fstats.parsed
        stats.rls += fstats.rls
        stats.rls_longest = max(stats.rls_longest, fstats.rls_longest)
        per_file.append((i, hits, hitseqs))

    if world > 1:                     # each process filled only its files
        flens = _all_reduce(flens)
        _merge_stats(stats)
    offs = np.concatenate([[0], np.cumsum(flens)[:-1]])

    # local hits with (file idx, in-file order) merge keys
    rows, blobs = [], []
    for i, hits, hitseqs in per_file:
        for j, (h, hs) in enumerate(zip(hits, hitseqs)):
            b = hs.encode('latin-1')
            rows.append((i, j, h.seq_nr, h.file_pos + offs[i],
                         h.seq_pos, h.length, h.readlength, len(b)))
            blobs.append(b)
    arr = np.asarray(rows, dtype=np.int64).reshape(-1, 8)

    if world > 1:
        parts = _exchange(arr, b''.join(blobs))
        arr = np.concatenate([r for r, _ in parts])
        blobs = []
        for r, blob in parts:
            ends = np.cumsum(r[:, 7])
            blobs += [blob[e - n:e] for e, n in zip(ends, r[:, 7])]
    # global order: file order, then in-file emission order
    order = np.lexsort((arr[:, 1], arr[:, 0])) if len(arr) else []
    hits_out, hitseqs_out = [], []
    for k in order:
        i, j, seq_nr, fpos, seq_pos, length, rl, _ = arr[k]
        hits_out.append(Hit(int(seq_nr), int(fpos), int(seq_pos),
                            int(length), int(rl)))
        hitseqs_out.append(blobs[k].decode('latin-1'))
    return tuple(hits_out), hitseqs_out


def scan_sharded(fnames, seqs, maxerrors, minoverlap, minreadlength,
                 Amin, mesh=None, nthreads=8, Lpad=None, b_local=2048,
                 stats=None, device='cuda'):
    '''
    coverage scan of a corpus over every process, each driving ``mesh``
    (default: :py:func:`local_mesh` on ``device``, the process's share of
    its host's cards) over its own file shard.  Every process returns the same
    results:

    :returns: ``(coverages, seqhits, seqbasehits)`` -- ``coverages`` is a
        list of int64 [5, S] base-count arrays in ``seqs`` order (feed to
        :py:func:`kvarq_tpu.engine.tensor_scan.fold_into_coverage`);
        ``stats`` ends up corpus-global.

    Every batch is padded to one ``Lpad``, so every process accumulates
    the same bank layout.  ``Lpad=None`` sizes it: each process samples
    the head of its own files (:py:func:`sample_max_readlen`), the maximum
    over all processes rounds up to the reader's bucket table.  A read
    longer than every sampled read raises, asking for ``Lpad``
    (``KVARQ_MULTIHOST_LPAD`` sets it without code changes).
    '''
    from kvarq_tpu_torch.engine.sieve import KmerSieve

    rank, world = _world()
    fnames = list(fnames)
    mine = [fnames[i]
            for i in sorted(shard_file_indices(fnames, rank, world))]

    if Lpad is None and os.environ.get('KVARQ_MULTIHOST_LPAD'):
        Lpad = int(os.environ['KVARQ_MULTIHOST_LPAD'])
    if Lpad is None:
        local_max = sample_max_readlen(mine)
        if world > 1:
            local_max = int(_all_reduce([local_max], 'max')[0])
        Lpad = reader._round_up(max(local_max, 128))
        lo.info('multihost scan: auto Lpad=%d (sampled max read length %d)'
                % (Lpad, local_max))

    seqs = list(seqs)
    mesh = mesh if mesh is not None else local_mesh(device)
    lo.info('process %d of %d: %d of %d files on %s'
            % (rank, world, len(mine), len(fnames), mesh))
    scanner = ShardedScanner(seqs, maxerrors, minoverlap, mesh)
    scanner.B_LOCAL = b_local
    sieve = KmerSieve.build(seqs, maxerrors, minoverlap, minreadlength)
    if sieve is not None:
        # sieve-fed batches are candidate-dense: no screen, exact pass
        scanner.assume_dense()
    bank = scanner.context(Lpad)
    stats = stats if stats is not None else reader.ReaderStats()

    src = reader.prefetch(reader.batches(
        mine, ord(Amin), minreadlength, stats, sieve=sieve,
        nthreads=nthreads, raw=False)) if mine else ()
    for batch in src:
        B, L = batch.codes.shape
        if L > Lpad:
            raise ValueError(
                'read length %d exceeds Lpad=%d (auto-sized from the first '
                '%d records per file); pass Lpad= explicitly or set '
                'KVARQ_MULTIHOST_LPAD' % (L, Lpad, 4096))
        if L < Lpad:
            codes = np.full((B, Lpad), encode.CODE_READ_JUNK, np.uint8)
            codes[:, :L] = batch.codes
            batch = reader.RecordBatch(codes, batch.rl, batch.filepos,
                                       batch.raw)
        scanner.scan_batch(batch)
    scanner.finalize()

    acc = scanner.basecounts.get(Lpad, np.zeros(
        (mesh.shape['bank'], encode.NBASE, bank.G), dtype=np.int64))
    seqhits, seqbasehits = scanner.seqhits, scanner.seqbasehits
    if world > 1:
        # the one merge: coverage and stat sums in one all_reduce
        T = len(seqs)
        merged = _all_reduce(np.concatenate(
            [acc.ravel(), seqhits, seqbasehits]))
        acc = merged[:acc.size].reshape(acc.shape)
        seqhits = merged[acc.size:acc.size + T]
        seqbasehits = merged[acc.size + T:]
        _merge_stats(stats)

    per_template = [np.zeros((encode.NBASE, len(s)), dtype=np.int64)
                    for s in seqs]
    bank.fold(acc, per_template)
    return per_template, seqhits, seqbasehits
