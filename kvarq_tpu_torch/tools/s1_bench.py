#!/usr/bin/env python
'''
S1, the exact scoring kernel (csrc/score_step.cu), on the card at the
main path's shape: exactness against its plain version
(``pallas_scan.score_candidates_ref``), its time beside its bound, and
where its time goes inside the kernel; and H1, the exact hit extraction
of the same source (``kvq_hit_extract``), dense and gathered, against
``pallas_scan.hit_triplets_ref`` beside its bound.  With ``--k1``: K1,
the candidate screen (csrc/cand_screen.cu, ``cand_counts``) alone,
against ``cand_counts_ref``, beside its bound and, as context, the fp16
and int8 one-hot products alone (``torch.matmul``, ``torch._int_mm``).

Methodology: the MTBC bank (Lpad 128, nch 4, 2 errors, minoverlap 25);
one batch of ``--batch`` reads (16,384) of ``--readlen`` bases, a
``--hitfrac`` of them planted from template loci (seed 20260820), on the
card.  The forms of S1's launch: ``dense`` (every read: the step of the
sieved path), ``gathered`` (the reads K1 flags, compacted on the card:
the unsieved step) and ``above_gather_k`` (the same rows as the step
whose count is above its ``gather_k`` scores them; the kernel's grid
does not depend on the count, so it is one launch shape with
``gathered``), and with ``--deep`` a batch whose every read is the same
planted read, so that one locus takes all the coverage.  Each form is
checked exactly against the plain version, then timed with CUDA events,
median of 5, in turns plain, kernel, kernel, plain.  Its bound is the
longer of the one-hot product's int8 operations at the card's peak and
its bytes (inputs read once, outputs written once) at the memory rate.
The split is one more launch with the kernel's profile buffer: each
warpgroup's ``clock64()`` cycles per phase (``PROFILE_PHASES``), as
shares of the consumer warpgroups' total.  H1 takes the forms ``dense``
and ``gathered`` of the same batch, compared as sorted triplet sets and
timed and split the same way (the profiled launch's triplets checked
too); its bound adds the triplets written to the product's.  K1 is timed the same way on the
same batch (``--k1``; its bound counts the staged one-hot bank and the
screen terms it reads and the counts it writes).  The ``--k1`` mode uses
only the port's public functions, so an older checkout's K1 is timed by
this file with that checkout first on the path, in turns with this one:

    PYTHONPATH=old python kvarq_tpu_torch/tools/s1_bench.py --k1

Usage:
    python -m kvarq_tpu_torch.tools.s1_bench [--batch 16384] [--deep] [--k1]

The last line of the output is one JSON object with the numbers and the
device they were taken on.
'''

import argparse
import json
import re
import subprocess
import sys

import numpy as np
import torch

LPAD = 128
MAXERRORS = 2
MINOVERLAP = 25
SPACING = 25
# the least time of the work on an H100 SXM at 700 W (NVIDIA's data
# sheet, dense): int8 tensor-core operations and HBM bytes
INT8_TOPS = 1979.0
HBM_TBPS = 3.35


def cuda_time_ms(fn, reps=5):
    ''' median of ``reps`` CUDA-event timings of fn() after one warm-up '''
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def kernel_ms(fn, name, reps=20):
    ''' the median device time (ms) of the kernels called ``name`` in
        ``reps`` calls of fn() under torch.profiler, after one warm-up: the
        kernel alone, without the launch's host time, which CUDA events
        around one small launch include '''
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    times = [e.device_time for e in prof.events()
             if e.device_type == DeviceType.CUDA and name in e.name]
    return float(np.median(times)) / 1e3 if times else None


def roofline(ops, nbytes):
    ''' the least time of ``ops`` int8 operations and ``nbytes`` bytes on
        the card: the longer of the two at its peak rates '''
    t_ops = ops / (INT8_TOPS * 1e12) * 1e3
    t_bytes = nbytes / (HBM_TBPS * 1e12) * 1e3
    return dict(ops=ops, bytes=nbytes, bound_ms=max(t_ops, t_bytes),
                bound_by='operations' if t_ops >= t_bytes else 'bytes')


def s1_bound(rows, Lpad, state, gathered):
    ''' S1's bound at this call: the one-hot product of the ``rows`` it
        scores (2 * rows * Lpad * nch * Qp int8 operations) at the card's
        int8 peak, or its bytes at the memory rate -- the scored rows'
        codes and read lengths (and indices when ``gathered``), the bank
        bytes, qmeta and tseg read once, the int64 basecount, seqhits and
        seqbasehits written once -- whichever is longer '''
    ops = 2.0 * rows * Lpad * state.nch * state.Qp
    nbytes = (rows * (Lpad + 4 + (4 if gathered else 0))
              + state.bank.numel() + 4 * state.qmeta.numel()
              + 4 * state.tseg.numel() + 8 * (5 * state.G + 2 * (state.T + 1)))
    return roofline(ops, nbytes)


def k1_bound(B, Lpad, state):
    ''' K1's bound at this call: the one-hot product's 2 * B * Lpad * nch
        * Qp int8 operations at the card's int8 peak, or its bytes at the
        memory rate -- the codes and read lengths, the staged one-hot bank
        (``state.onehot``) and the screen terms (``state.sterms``) read
        once, the int32 counts written once -- whichever is longer '''
    ops = 2.0 * B * Lpad * state.nch * state.Qp
    nbytes = (B * (Lpad + 4) + state.onehot.numel()
              + 4 * state.sterms.numel() + 4 * B)
    return roofline(ops, nbytes)


def int8_product_ms(tps, codes, state, reps=5):
    ''' the int8 one-hot product alone, ``torch._int_mm`` of the one-hot
        reads ``[B, Lpad * nch]`` and ``K`` (int32 out, no screen), the
        faster of K row-major and column-major; ``(ms, None)``, or
        ``(None, the error)`` where the call takes neither '''
    B = codes.shape[0]
    a = tps.one_hot(codes, state.nch, torch.int8).reshape(B, -1)
    k = state.K.to(torch.int8)
    times, err = [], None
    for b in (k, k.t().contiguous().t()):
        try:
            times.append(cuda_time_ms(lambda: torch._int_mm(a, b), reps))
        except RuntimeError as e:
            err = str(e).splitlines()[0]
    return (min(times), None) if times else (None, err)


def measure_k1(tps, codes, rl, state, e, mo, reps=5):
    ''' K1 (``cand_counts``) on one batch: exactness against
        ``cand_counts_ref`` (raises AssertionError), times (CUDA events,
        median of ``reps``, plain, kernel, kernel, plain; the kernel alone
        under the profiler), bound and, as context, the fp16 one-hot
        product alone as cuBLAS runs it (``matmul_ms``) and the int8 one
        (``int_mm_ms``, :py:func:`int8_product_ms`).
        :returns: ``{rows, candidates, ms, kernel_ms, plain_ms, ms_runs,
        bound_ms, bound_by, ops, bytes, max_abs_err, matmul_ms, int_mm_ms,
        int_mm_error}`` '''
    B, Lpad = codes.shape
    nch = state.nch
    got = tps.cand_counts(codes, rl, state, e, mo, nch)
    want = tps.cand_counts_ref(codes, rl, state, e, mo, nch)
    torch.cuda.synchronize()
    err = int((got - want).abs().max())
    assert err == 0, ('K1 differs from cand_counts_ref (max abs err %d)'
                      % err)
    candidates = int((want > 0).sum())
    del got, want

    def kernel():
        tps.cand_counts(codes, rl, state, e, mo, nch)

    def plain():
        tps.cand_counts_ref(codes, rl, state, e, mo, nch)
    times = [cuda_time_ms(f, reps) for f in (plain, kernel, kernel, plain)]
    flat = tps.one_hot(codes, nch, state.K.dtype).reshape(B, -1)
    mm_ms = cuda_time_ms(lambda: flat @ state.K, reps)
    del flat
    int_mm_ms, int_mm_error = int8_product_ms(tps, codes, state, reps)
    b = k1_bound(B, Lpad, state)
    return dict(rows=B, candidates=candidates, ms=min(times[1:3]),
                kernel_ms=kernel_ms(kernel, 'cand_screen_kernel'),
                plain_ms=min(times[0], times[3]), ms_runs=times,
                bound_ms=b['bound_ms'], bound_by=b['bound_by'], ops=b['ops'],
                bytes=b['bytes'], max_abs_err=err, matmul_ms=mm_ms,
                int_mm_ms=int_mm_ms, int_mm_error=int_mm_error)


def describe_k1(r):
    ''' one line of :py:func:`measure_k1`'s result '''
    return ('K1: %d rows, %d candidates, exact; kernel %.4f / %.4f ms, plain '
            '%.3f / %.3f ms (CUDA events, plain, kernel, kernel, plain); the '
            'kernel alone %.4f ms (profiler); bound %.4f ms (%.3g int8 '
            'operations, %.3g bytes: %s-bound), the kernel at %.1f%% of it; '
            'context, no screen: the fp16 one-hot product alone (torch.matmul)'
            ' %.4f ms, the int8 one (torch._int_mm) %s' % (
                r['rows'], r['candidates'], r['ms_runs'][1], r['ms_runs'][2],
                r['ms_runs'][0], r['ms_runs'][3],
                r['kernel_ms'] or float('nan'), r['bound_ms'], r['ops'],
                r['bytes'], r['bound_by'],
                100 * r['bound_ms'] / (r['kernel_ms'] or r['ms']),
                r['matmul_ms'], '%.4f ms' % r['int_mm_ms']
                if r['int_mm_ms'] is not None
                else 'refused (%s)' % r['int_mm_error']))


def ptxas_summary(report):
    ''' registers, shared memory and spills of each kernel entry in an
        ``nvcc -Xptxas -v`` report, each named by its kernel and template
        arguments (``score_step_kernel SP=4,0``: the depth bytes per read
        position of nch 4, no profile buffer) '''
    entries = [['file']]
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = re.search(r'[a-z_]+_kernel', m.group(1))
            args = re.findall(r'Li(\d+)E|Lb([01])E', m.group(1))
            entries.append([(name.group(0) + ' ' if name else '')
                            + ('SP=' + ','.join(a or b for a, b in args)
                               if args else m.group(1))])
        elif (('registers' in line or 'spill' in line or 'serialized' in line
               or 'setmaxnreg' in line) and 'is injected' not in line):
            entries[-1].append(line.split('ptxas info    :')[-1].strip())
    return ' | '.join('%s: %s' % (e[0], '; '.join(e[1:]))
                      for e in entries if len(e) > 1)


def synth_batch(windows, B, readlen, hitfrac, seed=20260820, deep=False):
    ''' ``(codes [B, LPAD] uint8, rl [B] int32)`` on the host: random
        reads, a ``hitfrac`` of them a template window's piece at a random
        offset; with ``deep`` every read is the same planted piece '''
    from kvarq_tpu_torch.engine import encode
    rng = np.random.RandomState(seed)
    bases = np.frombuffer(b'ACGT', dtype=np.uint8)
    raw = bases[rng.randint(4, size=(B, LPAD))]
    rl = np.full(B, readlen, dtype=np.int32)
    planted = np.arange(1) if deep else np.flatnonzero(rng.rand(B) < hitfrac)
    for i in planted:
        w = windows[rng.randint(len(windows))].encode()
        off = rng.randint(max(1, len(w) - readlen + 1))
        piece = np.frombuffer(w[off:off + readlen], np.uint8)
        raw[i, :len(piece)] = piece
    if deep:
        raw[:] = raw[0]
    codes = encode.encode_read_array(raw)
    codes[np.arange(LPAD)[None, :] >= rl[:, None]] = encode.CODE_READ_JUNK
    return codes, rl


def forms(tps, codes, rl, state, e, mo, deep=False):
    ''' ``[(form, args, rows)]``: the score_candidates arguments after
        (codes, rl, state, e, mo) of each form, and the rows it scores '''
    B = codes.shape[0]
    if deep:
        return [('deep', (), B)]
    idx, count = tps.compact(tps.cand_counts(codes, rl, state, e, mo,
                                             state.nch) > 0)
    n = int(count)
    return [('dense', (), B), ('gathered', (idx, count), n),
            ('above_gather_k', (idx, count), n)]


def split(tps, launch, device):
    ''' one launch with the profile buffer, ``launch(prof)``: ``{phase:
        share of the consumer warpgroups' cycles}`` plus ``cycles`` (their
        total) and the producer's ``stage`` and ``stage_wait`` cycles '''
    prof = torch.zeros(len(tps.PROFILE_PHASES), dtype=torch.int64,
                       device=device)
    launch(prof)
    torch.cuda.synchronize()
    cyc = dict(zip(tps.PROFILE_PHASES, prof.tolist()))
    total = max(1, cyc['total'])
    out = {k: cyc[k] / total for k in ('build', 'mma', 'screen', 'drain',
                                        'wait')}
    out.update(cycles=cyc['total'], stage=cyc['stage'],
               stage_wait=cyc['stage_wait'])
    return out


def measure(tps, codes, rl, state, e, mo, deep=False, reps=5):
    ''' every form of :py:func:`forms`: exactness against the plain version
        (raises AssertionError), times, bound and split.
        :returns: ``{form: {rows, ms, plain_ms, ms_runs, bound_ms,
        bound_by, ops, bytes, max_abs_err, hit_weight, split}}`` '''
    Lpad = codes.shape[1]
    out = {}
    for form, args, rows in forms(tps, codes, rl, state, e, mo, deep):
        got = tps.score_candidates(codes, rl, state, e, mo, *args)
        want = tps.score_candidates_ref(codes, rl, state, e, mo, *args)
        torch.cuda.synchronize()
        err = max(int((g - w).abs().max()) for g, w in zip(got, want))
        assert err == 0, ('S1 differs from score_candidates_ref, %s (max '
                          'abs err %d)' % (form, err))
        weight = int(want[1][:-1].sum())
        del got, want

        def kernel(args=args):
            tps.score_candidates(codes, rl, state, e, mo, *args)

        def plain(args=args):
            tps.score_candidates_ref(codes, rl, state, e, mo, *args)
        times = [cuda_time_ms(f, reps) for f in (plain, kernel, kernel, plain)]
        b = s1_bound(rows, Lpad, state, bool(args))
        out[form] = dict(rows=rows, ms=min(times[1:3]),
                         kernel_ms=kernel_ms(kernel, 'score_step_kernel'),
                         plain_ms=min(times[0], times[3]), ms_runs=times,
                         bound_ms=b['bound_ms'], bound_by=b['bound_by'],
                         ops=b['ops'], bytes=b['bytes'], max_abs_err=err,
                         hit_weight=weight,
                         split=split(tps, lambda p, args=args:
                                     tps.score_candidates(
                                         codes, rl, state, e, mo, *args,
                                         profile=p), codes.device))
    return out


def hit_bound(rows, Lpad, state, gathered, triplets):
    ''' H1's bound at this call: the one-hot product of the ``rows`` it
        extracts at the card's int8 peak, or its bytes at the memory rate
        -- the rows' codes and read lengths (and indices when
        ``gathered``), the bank bytes, qmeta and tseg read once, the int32
        triplets and their counter written once -- whichever is longer '''
    ops = 2.0 * rows * Lpad * state.nch * state.Qp
    nbytes = (rows * (Lpad + 4 + (4 if gathered else 0))
              + state.bank.numel() + 4 * state.qmeta.numel()
              + 4 * state.tseg.numel() + 12 * triplets + 4)
    return roofline(ops, nbytes)


def _tri_sorted(tri):
    return tri[np.lexsort(tri.T[::-1])]


def measure_hits(tps, codes, rl, state, e, mo, reps=5):
    ''' H1 (``hit_triplets``) in the forms ``dense`` (every row) and
        ``gathered`` (the rows K1 flags, compacted on the card, the count
        read there): exactness against ``hit_triplets_ref`` as sorted
        triplet sets (raises AssertionError), times (CUDA events, median of
        ``reps``, plain, kernel, kernel, plain; the kernel alone under the
        profiler), bound and the split of one launch with the profile
        buffer, whose triplets must be the same set.
        :returns: ``{form: {rows, triplets, ms, kernel_ms, plain_ms,
        ms_runs, bound_ms, bound_by, ops, bytes, max_abs_err, split}}`` '''
    Lpad = codes.shape[1]
    out = {}
    for form, args, rows in forms(tps, codes, rl, state, e, mo)[:2]:
        want, n = tps.triplets_to_host(*tps.hit_triplets_ref(
            codes, rl, state, e, mo, *args, cap=None))
        cap = 1 << max(n, tps.HIT_CAP).bit_length()
        got, gn = tps.triplets_to_host(*tps.hit_triplets(
            codes, rl, state, e, mo, *args, cap=cap))
        assert gn == n and np.array_equal(_tri_sorted(got),
                                          _tri_sorted(want)), (
            'H1 differs from hit_triplets_ref, %s (%d triplets against %d)'
            % (form, gn, n))

        def kernel(args=args):
            tps.hit_triplets(codes, rl, state, e, mo, *args, cap=cap)

        def plain(args=args):
            tps.hit_triplets_ref(codes, rl, state, e, mo, *args, cap=cap)
        times = [cuda_time_ms(f, reps) for f in (plain, kernel, kernel, plain)]
        b = hit_bound(rows, Lpad, state, bool(args), n)
        profiled = []

        def launch(prof, args=args):
            profiled.append(tps.hit_triplets(codes, rl, state, e, mo, *args,
                                             cap=cap, profile=prof))
        sp = split(tps, launch, codes.device)
        pgot, pn = tps.triplets_to_host(*profiled[0])
        assert pn == n and np.array_equal(_tri_sorted(pgot),
                                          _tri_sorted(want)), (
            'H1 with its profile buffer differs, %s' % form)
        out[form] = dict(rows=rows, triplets=n, ms=min(times[1:3]),
                         kernel_ms=kernel_ms(kernel, 'hit_extract_kernel'),
                         plain_ms=min(times[0], times[3]), ms_runs=times,
                         bound_ms=b['bound_ms'], bound_by=b['bound_by'],
                         ops=b['ops'], bytes=b['bytes'], max_abs_err=0,
                         split=sp)
    return out


def _split_text(s):
    ''' a :py:func:`split` as text '''
    return ('split of %d warpgroup cycles: build %.1f%%, mma %.1f%%, screen '
            '%.1f%%, drain %.1f%%, waits %.1f%%; producer staging %d, '
            'waiting %d cycles' % (
                s['cycles'], 100 * s['build'], 100 * s['mma'],
                100 * s['screen'], 100 * s['drain'], 100 * s['wait'],
                s['stage'], s['stage_wait']))


def describe_hits(form, r):
    ''' one line of :py:func:`measure_hits`'s result for ``form`` '''
    return ('H1 %s: %d rows, %d triplets, exact; the call %.4f / %.4f ms, '
            'plain %.3f / %.3f ms (CUDA events, plain, kernel, kernel, '
            'plain); the kernel alone %.4f ms (profiler); bound %.4f ms (%s), '
            'the kernel at %.1f%% of it; %s' % (
                form, r['rows'], r['triplets'], r['ms_runs'][1],
                r['ms_runs'][2], r['ms_runs'][0], r['ms_runs'][3],
                r['kernel_ms'] or float('nan'), r['bound_ms'], r['bound_by'],
                100 * r['bound_ms'] / (r['kernel_ms'] or r['ms']),
                _split_text(r['split'])))


def describe(form, r):
    ''' one line of :py:func:`measure`'s result for ``form`` '''
    return ('%s: %d rows, %d hit weight, exact; kernel %.4f / %.4f ms, plain '
            '%.3f / %.3f ms (CUDA events, plain, kernel, kernel, plain); the '
            'kernel alone %.4f ms (profiler); bound %.4f ms (%s), the kernel '
            'at %.1f%% of it; %s' % (
                form, r['rows'], r['hit_weight'], r['ms_runs'][1],
                r['ms_runs'][2], r['ms_runs'][0], r['ms_runs'][3],
                r['kernel_ms'] or float('nan'), r['bound_ms'], r['bound_by'],
                100 * r['bound_ms'] / (r['kernel_ms'] or r['ms']),
                _split_text(r['split'])))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--batch', type=int, default=16384,
                    help='reads per batch (the engine\'s default batchsize)')
    ap.add_argument('--hitfrac', type=float, default=0.03,
                    help='fraction of reads planted from template loci')
    ap.add_argument('--readlen', type=int, default=101)
    ap.add_argument('--deep', action='store_true',
                    help='also score a batch of one planted read repeated')
    ap.add_argument('--k1', action='store_true',
                    help='time K1, the candidate screen, alone')
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print('s1_bench: no CUDA device', file=sys.stderr)
        return 1

    from kvarq_tpu_torch import bench, device
    from kvarq_tpu_torch.analyse import Analyser
    from kvarq_tpu_torch.engine import native_cuda
    from kvarq_tpu_torch.engine import pallas_scan as tps
    from kvarq_tpu_torch.engine import tensor_scan

    dev = device.select('cuda')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else torch.cuda.get_device_name(dev)
    sources = ['cand_screen.cu'] if args.k1 else ['cand_screen.cu',
                                                  'score_step.cu']
    native_cuda.load_all(sources)
    print('ptxas -v of %s: %s' % (sources[-1], ptxas_summary(
        native_cuda.ptxas_report.get(sources[-1], ''))))
    covs = Analyser().load_coverages(bench.load_mtbc(), spacing=SPACING)
    seqs = [c.plus_seq.bases for c in covs.values()]
    seqs += [c.minus_seq.bases for c in covs.values()]
    windows = bench.template_windows(bench.load_mtbc())
    bank = tensor_scan.build_bank(seqs, LPAD, MINOVERLAP)
    state = tps.device_arrays(bank, len(seqs), dev)
    if args.k1:
        codes, rl = synth_batch(windows, args.batch, args.readlen,
                                args.hitfrac)
        k1 = measure_k1(tps, torch.from_numpy(codes).to(dev),
                        torch.from_numpy(rl).to(dev), state, MAXERRORS,
                        MINOVERLAP)
        print('%s; %s' % (describe_k1(k1), card), flush=True)
        print(json.dumps({'metric': 's1_bench_k1', 'device': card,
                          'B': args.batch, 'Lpad': LPAD, 'Qp': state.Qp,
                          'nch': state.nch, 'k1': k1}))
        return 0
    result, hits = {}, {}
    for deep in (False, True) if args.deep else (False,):
        codes, rl = synth_batch(windows, args.batch, args.readlen,
                                args.hitfrac, deep=deep)
        c = torch.from_numpy(codes).to(dev)
        r = torch.from_numpy(rl).to(dev)
        got = measure(tps, c, r, state, MAXERRORS, MINOVERLAP, deep)
        for form, v in got.items():
            print('%s; %s' % (describe(form, v), card), flush=True)
        result.update(got)
        if not deep:
            hits = measure_hits(tps, c, r, state, MAXERRORS, MINOVERLAP)
            for form, v in hits.items():
                print('%s; %s' % (describe_hits(form, v), card), flush=True)
    print(json.dumps({'metric': 's1_bench', 'device': card, 'B': args.batch,
                      'Lpad': LPAD, 'Qp': state.Qp, 'nch': state.nch,
                      'forms': result, 'hit_forms': hits}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
