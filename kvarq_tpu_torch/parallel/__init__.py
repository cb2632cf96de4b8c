'''
Scale-out of the port over several devices (counterpart of
kvarq_tpu/parallel/__init__.py): the scan sharded over a 2-D
``('data', 'bank')`` mesh of torch devices.

- ``data`` axis: every step's rows are split into ``n_data`` slices.
- ``bank`` axis: the template bank is split into ``n_bank`` contiguous
  template ranges (:py:class:`ShardBank`, kvarq_tpu's numpy layout); each
  shard gets its own :py:class:`~kvarq_tpu_torch.engine.pallas_scan.BankState`
  whose ``tseg`` uses *global* template numbering.

Mesh entry ``(i, j)`` runs the single-device step
(:py:func:`~kvarq_tpu_torch.engine.pallas_scan.scan_step_banked`, or the
candidate screen alone for the hit path) on data slice ``i`` against bank
shard ``j``, on its own device.  The results merge exactly in int64 on
the mesh's first device -- the ``psum`` of the JAX package: ``basecount``
summed over the data axis per bank shard, ``seqhits``/``seqbasehits``
over both axes.  Every (read, template) pair is scored on exactly one
entry, so the merged result equals the single-device scan bit for bit.

The entries run one after another from the calling thread.  On one card
(a mesh that repeats it, as the tests and ``chip_smoke.py`` build) they
share one stream, so their temporaries do not add up.  A step reads
nothing back to the host (the candidate count stays on each entry's
card), so the entries of a multi-card mesh are enqueued without waiting;
each card runs its own entries in turn on its current stream.
'''

import numpy as np
import torch

from kvarq_tpu_torch import device as _device
from kvarq_tpu_torch.engine import encode, pallas_scan
from kvarq_tpu_torch.engine.match_xla import _Bank
from kvarq_tpu_torch.engine.pallas_scan import pack_qmeta, pack_tseg
from kvarq_tpu_torch.engine.tensor_scan import (TensorScanner, score_rows,
                                                screens)
from kvarq_tpu_torch.log import lo


class Mesh:
    ''' an ``[n_data, n_bank]`` grid of ``torch.device`` s; ``shape`` is
        ``{'data': n_data, 'bank': n_bank}`` as on a ``jax.sharding.Mesh``.
        Entries may repeat a device. '''

    def __init__(self, devices):
        self.devices = [[torch.device(d) for d in row] for row in devices]
        self.shape = {'data': len(self.devices),
                      'bank': len(self.devices[0])}
        self.size = self.shape['data'] * self.shape['bank']

    @property
    def first(self):
        ''' the device the results merge on '''
        return self.devices[0][0]

    def __repr__(self):
        return 'Mesh(%dx%d: %s)' % (
            self.shape['data'], self.shape['bank'],
            ' '.join(str(d) for row in self.devices for d in row))


def make_mesh(n_data=None, n_bank=1, devices=None, backend='cuda'):
    '''
    a 2-D ``('data', 'bank')`` mesh over ``devices``.

    With no ``devices``: on CUDA every card, and a mesh with more entries
    than cards raises, as the JAX reshape does (``n_data`` None puts every
    card on the data axis); on the CPU, which torch cannot split into
    virtual devices, every entry is ``cpu`` (``n_data`` None gives one
    entry).  An explicit ``devices`` list may repeat a device, e.g.
    ``[cuda:0] * 4`` for a 2x2 mesh on one card.  A CUDA device with no
    card raises, as :py:func:`kvarq_tpu_torch.device.select` does.
    '''
    if devices is None:
        dev = _device.select(backend)
        if dev.type == 'cpu':
            devices = [dev] * ((n_data or 1) * n_bank)
        else:
            devices = [torch.device('cuda', i)
                       for i in range(torch.cuda.device_count())]
    else:
        devices = [torch.device(d) for d in devices]
        for d in set(devices):
            _device.select(d)
    if n_data is None:
        n_data = len(devices) // n_bank
    n = n_data * n_bank
    if n_data < 1 or n_bank < 1 or n > len(devices):
        raise ValueError('a %dx%d mesh needs %d devices, %d given'
                         % (n_data, n_bank, n, len(devices)))
    return Mesh([devices[i * n_bank:(i + 1) * n_bank]
                 for i in range(n_data)])


def parse_mesh(spec, backend='cuda'):
    ''' mesh from a CLI/env spec: ``auto`` = every device on the data axis,
        ``NDxNB`` = explicit ('data', 'bank') shape (e.g. ``4x2``) '''
    spec = str(spec).strip().lower()
    if spec == 'auto':
        return make_mesh(backend=backend)
    try:
        n_data, _, n_bank = spec.partition('x')
        n_data, n_bank = int(n_data), int(n_bank) if n_bank else 1
    except (TypeError, ValueError):
        raise ValueError('mesh spec must be "auto" or "NDxNB" (e.g. 4x2), '
                         'got %r' % spec)
    return make_mesh(n_data, n_bank, backend=backend)


def split_templates(nseqs, n_bank):
    ''' contiguous template ranges [(lo, hi)...] per bank shard '''
    per = (nseqs + n_bank - 1) // n_bank
    return [(min(i * per, nseqs), min((i + 1) * per, nseqs))
            for i in range(n_bank)]


class ShardBank:
    ''' per-bank-shard template sub-banks, padded to a common width G so
        they stack into one [n_bank, ...] array, with ``tid`` in *global*
        template numbering (kvarq_tpu.parallel.ShardBank's numpy layout),
        plus one :py:class:`~kvarq_tpu_torch.engine.pallas_scan.BankState`
        per shard and device.  Every shard's state has the common ``G``
        and ``Qp`` (a multiple of ``QALIGN``), the channel count of the
        whole bank (:py:meth:`channels`), and ``tseg`` in global template
        numbering (``T`` for gap and padding columns). '''

    def __init__(self, seqs, Lpad, n_bank, minoverlap=None):
        self.Lpad = Lpad
        self.n_bank = n_bank
        self.ranges = split_templates(len(seqs), n_bank)
        banks = [_Bank(seqs[lo:hi], Lpad, minoverlap)
                 for lo, hi in self.ranges]
        self.G = max(b.G for b in banks) if banks else 0
        self.sub = banks

        codes, tid, d_of, seql_of = [], [], [], []
        for (lo, hi), b in zip(self.ranges, banks):
            gtid = b.tid.copy()
            gtid[gtid >= 0] += lo
            q_fill = self.G + Lpad - 1
            codes.append(np.pad(b.codes, (0, self.G - b.G),
                                constant_values=encode.CODE_TMPL_JUNK))
            tid.append(np.pad(gtid, (0, q_fill - b.Q), constant_values=-1))
            d_of.append(np.pad(b.d_of, (0, q_fill - b.Q)))
            seql_of.append(np.pad(b.seql_of, (0, q_fill - b.Q),
                                  constant_values=1))
        self.codes = np.stack(codes)        # [n_bank, G]
        self.tid = np.stack(tid)            # [n_bank, Q]
        self.d_of = np.stack(d_of)
        self.seql_of = np.stack(seql_of)

        self.T = len(seqs)
        self.nch = self.channels()
        self.Qp = max(-(-(self.G + Lpad - 1) // pallas_scan.QALIGN)
                      * pallas_scan.QALIGN, pallas_scan.QALIGN)
        self._states = {}

    def channels(self):
        ''' one-hot channel count, consistent over all shards '''
        return pallas_scan.bank_channels(self.codes)

    def state(self, j, device):
        ''' bank shard ``j`` on ``device`` (built once); None for a shard
            that holds no template '''
        lo_, hi = self.ranges[j]
        if hi == lo_:
            return None
        key = (j, torch.device(device))
        if key not in self._states:
            sub = self.sub[j]
            tseg = pack_tseg(sub, self.T, Qp=self.Qp)
            tseg[tseg != self.T] += lo_
            self._states[key] = pallas_scan._state(
                pallas_scan._padded_bank(sub.codes, self.Lpad, self.Qp),
                pack_qmeta(sub, Qp=self.Qp), tseg, self.Lpad, self.G,
                self.T, self.nch, device)
        return self._states[key]

    def fold(self, acc, per_template):
        ''' add the per-shard base counts ``acc [n_bank, 5, G]`` onto the
            per-template ``[5, S]`` arrays '''
        for shard, ((lo_, hi), sub) in enumerate(zip(self.ranges, self.sub)):
            for t in range(lo_, hi):
                pos = sub.tstart[t - lo_]
                S = per_template[t].shape[1]
                per_template[t] += acc[shard, :, pos:pos + S]


def _entries(mesh, codes, rl):
    ''' yield ``(i, j, device, codes, rl)`` for every mesh entry: data
        slice ``i`` of the host arrays ``codes [B, Lpad]``, ``rl [B]``
        (``B`` a multiple of ``n_data``) on entry ``(i, j)``'s device,
        copied there once per distinct device '''
    n_data = mesh.shape['data']
    B_local = len(codes) // n_data
    for i, row in enumerate(mesh.devices):
        sl = slice(i * B_local, (i + 1) * B_local)
        host = (torch.from_numpy(np.ascontiguousarray(codes[sl])),
                torch.from_numpy(np.ascontiguousarray(rl[sl], np.int32)))
        on = {}
        for j, dev in enumerate(row):
            if dev not in on:
                on[dev] = tuple(t.to(dev, non_blocking=True) for t in host)
            yield (i, j, dev) + on[dev]


def _pad_rows(codes, rl, n_data):
    ''' pad rows with rl=0 junk reads to a multiple of ``n_data`` '''
    n = len(codes)
    return encode.pad_batch(codes, rl, -(-n // n_data) * n_data,
                            codes.shape[1])


def sharded_scan_step(mesh, bank, codes, rl, maxerrors, minoverlap, screen):
    '''
    one scan step over a chunk ``codes [B, Lpad] uint8``, ``rl [B]`` (host
    arrays, ``B`` a multiple of ``n_data``) on every entry of ``mesh``
    against ``bank`` (:py:class:`ShardBank`).

    Without ``screen`` every entry scores every row of its slice; with it
    every entry screens its slice with the candidate kernel and scores
    every candidate exactly.

    :returns: ``(basecount [n_bank, 5, G], seqhits [T+1], seqbasehits
        [T+1], launches)`` -- int64 tensors on ``mesh.first`` and an int64
        ``[n_data, n_bank]`` array of candidate-kernel launches per entry
    '''
    n_data, n_bank = mesh.shape['data'], mesh.shape['bank']
    first = mesh.first
    bc = torch.zeros((n_bank, encode.NBASE, bank.G), dtype=torch.int64,
                     device=first)
    sh = torch.zeros(bank.T + 1, dtype=torch.int64, device=first)
    sbh = torch.zeros(bank.T + 1, dtype=torch.int64, device=first)
    launches = np.zeros((n_data, n_bank), dtype=np.int64)
    for i, j, dev, c, r in _entries(mesh, codes, rl):
        state = bank.state(j, dev)
        if state is None:
            continue
        before = pallas_scan.cand_counts.launches
        b, s, sb, _ = pallas_scan.scan_step_banked(
            c, r, state, maxerrors, minoverlap, screen,
            score_rows(dev, state.Qp))
        launches[i, j] = pallas_scan.cand_counts.launches - before
        bc[j] += b.to(first)
        sh += s.to(first)
        sbh += sb.to(first)
    return bc, sh, sbh, launches


def sharded_hit_flags(mesh, bank, codes, rl, maxerrors, minoverlap):
    ''' the mesh hit path's flag step, host arrays as in
        :py:func:`sharded_scan_step`: :returns: ``(flags, launches)`` --
        ``[B]`` bool on ``mesh.first``, set where the candidate screen
        flags the read against ANY bank shard, and the candidate-kernel
        launches per entry '''
    B_local = len(codes) // mesh.shape['data']
    flags = torch.zeros(len(codes), dtype=torch.bool, device=mesh.first)
    launches = np.zeros((mesh.shape['data'], mesh.shape['bank']),
                        dtype=np.int64)
    for i, j, dev, c, r in _entries(mesh, codes, rl):
        state = bank.state(j, dev)
        if state is None:
            continue
        before = pallas_scan.cand_counts.launches
        f = pallas_scan.cand_counts(c, r, state, maxerrors, minoverlap,
                                    state.nch) > 0
        launches[i, j] = pallas_scan.cand_counts.launches - before
        flags[i * B_local:(i + 1) * B_local] |= f.to(mesh.first)
    return flags, launches


class ShardedMatcher:
    ''' mesh counterpart of
        :py:class:`kvarq_tpu_torch.engine.match_pallas.PallasMatcher` for
        the hit-list path (``findseqs`` with a mesh): every entry screens
        its data slice against its bank shard with the candidate kernel, a
        read is flagged if any shard flags it, the flagged rows are
        compacted on the mesh's first device
        (:py:func:`~kvarq_tpu_torch.engine.pallas_scan.compact`, the count
        stays there) and extracted exactly there by the full-bank
        :py:class:`~kvarq_tpu_torch.engine.match_xla.XlaMatcher` (on a card,
        the kernel H1), which reports batch rows, so ``Hit.file_pos`` stays
        global; one wait on the host per batch, for the triplets.
        ``launches`` counts the candidate-kernel launches per mesh
        entry. '''

    def __init__(self, seqs, maxerrors, minoverlap, mesh, b_local=2048):
        from kvarq_tpu_torch.engine.match_xla import XlaMatcher
        self.seqs = list(seqs)
        self.maxerrors = maxerrors
        self.minoverlap = minoverlap
        self.mesh = mesh
        self.b_local = b_local
        self.xla = XlaMatcher(seqs, maxerrors, minoverlap, mesh.first)
        self._banks = {}
        self.launches = np.zeros((mesh.shape['data'], mesh.shape['bank']),
                                 dtype=np.int64)

    def _bank(self, Lpad):
        if Lpad not in self._banks:
            self._banks[Lpad] = ShardBank(self.seqs, Lpad,
                                          self.mesh.shape['bank'],
                                          self.minoverlap)
        return self._banks[Lpad]

    def match_batch(self, batch):
        ''' :returns: int64 ``[n, 3]`` ``(b, template, d)`` triplets '''
        B, Lpad = batch.codes.shape
        bank = self._bank(Lpad)
        flags = torch.zeros(B, dtype=torch.bool, device=self.mesh.first)
        chunk = self.b_local * self.mesh.shape['data']
        for lo_ in range(0, B, chunk):
            codes, rl = _pad_rows(batch.codes[lo_:lo_ + chunk],
                                  batch.rl[lo_:lo_ + chunk],
                                  self.mesh.shape['data'])
            n = min(chunk, B - lo_)
            f, launches = sharded_hit_flags(self.mesh, bank, codes, rl,
                                            self.maxerrors, self.minoverlap)
            flags[lo_:lo_ + n] = f[:n]
            self.launches += launches
        idx, count = pallas_scan.compact(flags)
        return self.xla.extract(*self.xla.to_device(batch), idx, count)


class ShardedScanner:
    ''' mesh counterpart of
        :py:class:`kvarq_tpu_torch.engine.tensor_scan.TensorScanner`:
        accumulates per-template base counts and stats over batches,
        sharded over a ``('data', 'bank')`` mesh, bitwise equal to the
        single-device scanner.

        A batch is cut into steps of ``B_LOCAL`` rows per data slice (the
        last one padded with rl=0 rows to a multiple of ``n_data``).  Every
        entry screens its slice and scores the candidates where the
        single-device rule, ``tensor_scan.screens``, says so for the
        slice's rows, and scores every row otherwise;
        :py:meth:`assume_dense` (sieve-fed input) never screens.  The merged
        step results accumulate in int64 on the mesh's first device and
        flush to the host every ``FLUSH_STEPS`` steps.  ``launches`` counts
        the candidate-kernel launches per mesh entry. '''

    B_LOCAL = 2048
    SCREEN_MIN_ROWS = TensorScanner.SCREEN_MIN_ROWS
    FLUSH_STEPS = 64

    def __init__(self, seqs, maxerrors, minoverlap, mesh):
        self.seqs = list(seqs)
        self.maxerrors = maxerrors
        self.minoverlap = minoverlap
        self.T = len(self.seqs)
        self.mesh = mesh
        self.dense = False
        self._ctx = {}
        self.launches = np.zeros((mesh.shape['data'], mesh.shape['bank']),
                                 dtype=np.int64)
        self.reset()

    def assume_dense(self):
        ''' declare the input candidate-dense (sieve-fed batches): the
            per-entry candidate screen and compaction are skipped in favour
            of the exact full pass.  No-op once a context exists. '''
        if not self._ctx:
            self.dense = True

    def reset(self):
        self.basecounts = {}   # Lpad -> accumulated [n_bank, 5, G] int64
        self.seqhits = np.zeros(self.T, dtype=np.int64)
        self.seqbasehits = np.zeros(self.T, dtype=np.int64)
        for ctx in self._ctx.values():
            ctx.update(acc=None, steps=0)

    def context(self, Lpad):
        ''' the :py:class:`ShardBank` at ``Lpad`` (built on first use) '''
        if Lpad not in self._ctx:
            bank = ShardBank(self.seqs, Lpad, self.mesh.shape['bank'],
                             self.minoverlap)
            self._ctx[Lpad] = dict(bank=bank, acc=None, steps=0)
            lo.debug('Lpad %d: %s, shard G=%d Qp=%d nch=%d'
                     % (Lpad, self.mesh, bank.G, bank.Qp, bank.nch))
        return self._ctx[Lpad]['bank']

    def scan_batch(self, batch):
        if not self.T:
            return
        B, Lpad = batch.codes.shape
        bank = self.context(Lpad)
        ctx = self._ctx[Lpad]
        chunk = self.B_LOCAL * self.mesh.shape['data']
        for lo_ in range(0, B, chunk):
            codes, rl = _pad_rows(batch.codes[lo_:lo_ + chunk],
                                  batch.rl[lo_:lo_ + chunk],
                                  self.mesh.shape['data'])
            *step, launches = sharded_scan_step(
                self.mesh, bank, codes, rl, self.maxerrors, self.minoverlap,
                screens(self, len(codes) // self.mesh.shape['data']))
            self.launches += launches
            if ctx['acc'] is None:
                ctx['acc'] = step
            else:
                for a, d in zip(ctx['acc'], step):
                    a += d
            ctx['steps'] += 1
            if ctx['steps'] >= self.FLUSH_STEPS:
                self._flush(Lpad)

    def _flush(self, Lpad):
        ''' move the device accumulators into the host totals '''
        ctx = self._ctx[Lpad]
        if ctx['acc'] is None:
            return
        bc, sh, sbh = (a.cpu().numpy() for a in ctx['acc'])
        host = self.basecounts.setdefault(Lpad, np.zeros_like(bc))
        host += bc
        self.seqhits += sh[:self.T]
        self.seqbasehits += sbh[:self.T]
        ctx.update(acc=None, steps=0)

    def finalize(self):
        ''' flush all device accumulators; must be called before reading
            ``basecounts``/``seqhits``/``seqbasehits`` '''
        for Lpad in list(self._ctx):
            self._flush(Lpad)

    def coverages(self):
        ''' list (per template, ``seqs`` order) of int64 [5, S] base
            counts '''
        self.finalize()
        per_template = [np.zeros((encode.NBASE, len(s)), dtype=np.int64)
                        for s in self.seqs]
        for Lpad, acc in self.basecounts.items():
            self._ctx[Lpad]['bank'].fold(acc, per_template)
        return per_template


def dryrun(n_devices, backend='cuda'):
    ''' one sharded scan step with tiny shapes on a mesh of ``n_devices``
        entries (2 bank shards when even), the cards repeated cyclically
        when there are fewer; checks the planted read hits '''
    from kvarq_tpu_torch.engine.reader import RecordBatch
    if torch.device(backend).type == 'cpu':
        devices = ['cpu'] * n_devices
    else:
        _device.select(backend)
        ncards = torch.cuda.device_count()
        devices = ['cuda:%d' % (k % ncards) for k in range(n_devices)]
    n_bank = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    mesh = make_mesh(n_devices // n_bank, n_bank, devices)

    seqs = ['ACGTACGTACGTACGTACGTACGTA',
            'TTGACCTGAACGTTGACCTGAACGT',
            'CACCGGTGTAGGCAAGTCGTAACAAGG',
            'GGCATTTTCGGGGCATTTTCGGGGCATT']
    scanner = ShardedScanner(seqs, maxerrors=1, minoverlap=10, mesh=mesh)
    B, Lpad = 8 * n_devices, 64
    rng = np.random.RandomState(0)
    raw = rng.choice(np.frombuffer(b'ACGT', dtype=np.uint8), (B, Lpad))
    raw[0, :25] = np.frombuffer(seqs[0].encode(), dtype=np.uint8)
    codes = encode.encode_read_array(raw)
    rl = np.full(B, Lpad, dtype=np.int32)
    scanner.scan_batch(RecordBatch(codes, rl, np.zeros(B, dtype=np.int64),
                                   raw))
    covs = scanner.coverages()
    if len(covs) != len(seqs) or int(scanner.seqhits.sum()) < 1:
        raise RuntimeError('dryrun on %s: the planted read did not hit'
                           % mesh)
    return scanner
