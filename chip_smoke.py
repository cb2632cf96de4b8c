#!/usr/bin/env python3
'''
Smoke run of kvarq_tpu_torch on one NVIDIA GPU: builds the CUDA kernel
from this checkout, checks it against its plain PyTorch version at the
main-path shape, drives ``kvarq scan``'s coverage path over the 2M-read
bench corpus with and without the k-mer sieve, gates the result against
the numpy oracle and runs the CLI on the golden MTBC fixtures.

    python3 chip_smoke.py

Every phase prints one line; any failure exits non-zero before the
result lines.  The ``[trace]`` lines time one scan per sieve mode under
torch.profiler (kernel time on the card, its busy share, the top
kernels).  The last two lines are the kernel table and
``{"ok": true, "device": {...}}``.  Work files go to
build/kvarq_tpu_torch/smoke/.
'''

import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.abspath(os.path.dirname(__file__))
WORK = os.path.join(HERE, 'build', 'kvarq_tpu_torch', 'smoke')
N_READS = 2000000
READLEN = 101
MAIN_B = 16384      # reads per batch, as the engine's default batchsize
# CLI defaults (kvarq_tpu/config.py): e=2, o=25, r=25, Q13 on Sanger
SCAN = dict(maxerrors=2, minoverlap=25, minreadlength=25, nthreads=8,
            Amin=chr(33 + 13))
GOLDEN = {
    'L3_N1014_hits_5k.fastq': (
        ['--variant', 'Illumina 1.8+'],
        ['lineage 3', 'Streptomycin resistance::SNP781687AG=rpsL.K43R',
         'Rifampicin resistance (RRDR) '
         '[761139CG=rpoB.H445D 761140AG=rpoB.H445R]',
         '703777740003771']),
    'N0116_1_hits_1k.fastq': (
        [], ['lineage 2', 'Streptomycin resistance::SNP781687AG=rpsL.K43R']),
}


class SmokeFailure(Exception):
    pass


def check(ok, msg):
    if not ok:
        raise SmokeFailure(msg)


def say(phase, msg):
    print('[%s] %s' % (phase, msg), flush=True)


def cuda_time_ms(fn, reps=5):
    ''' median of ``reps`` CUDA-event timings of fn() after one warm-up '''
    import torch
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


def run(cmd, env=None, timeout=300):
    proc = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True,
                          timeout=timeout, env=dict(os.environ, **(env or {})))
    check(proc.returncode == 0, '%s exited %d:\n%s'
          % (' '.join(cmd), proc.returncode, proc.stderr[-4000:]))
    return proc.stdout


def corpus(seqs_windows):
    ''' the bench corpus (bench.generate_fastq, seed 20260817) and its
        first 8192 reads '''
    import bench
    os.makedirs(WORK, exist_ok=True)
    path = os.path.join(WORK, 'mtbc_%dx%d.fastq' % (N_READS, READLEN))
    prefix = os.path.join(WORK, 'mtbc_prefix_8192.fastq')
    if not os.path.exists(path):
        bench.generate_fastq(path + '.tmp', seqs_windows, N_READS, READLEN)
        os.replace(path + '.tmp', path)
    with open(path) as f, open(prefix, 'w') as g:
        for _ in range(4 * 8192):
            g.write(f.readline())
    return path, prefix


def traced_scan(engine, path, seqs):
    ''' one countseqs under torch.profiler: (wall s, kernel s on the card,
        K1 s, [(kernel, ms)] of the five longest) '''
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        engine.countseqs(path, seqs)
        torch.cuda.synchronize()
        wall = time.time() - t0
    dev = sorted((e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA),
                 key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in dev) / 1e6
    k1 = sum(e.self_device_time_total for e in dev
             if 'cand_screen_kernel' in e.key) / 1e6
    return wall, busy, k1, [(e.key[:48], e.self_device_time_total / 1e3)
                            for e in dev[:5]]


def oracle_gate(ret, prefix, seqs, found):
    ''' bench.assert_device_matches_oracle with the numpy matcher of the
        shared (jax-free) kvarq_tpu engine configured like the scan '''
    import bench
    from kvarq_tpu import engine as oracle_engine
    oracle_engine.config(**SCAN)
    try:
        return bench.assert_device_matches_oracle(ret, prefix, seqs,
                                                  found=found)
    except SystemExit as e:
        raise SmokeFailure(str(e))


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is False', file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import bench
    from kvarq_tpu_torch import device, engine
    from kvarq_tpu_torch.engine import native_cuda, reader
    from kvarq_tpu_torch.engine import pallas_scan as tps
    from kvarq_tpu_torch.engine import tensor_scan as tts

    t_start = time.time()
    dev = device.select('cuda')
    kind = torch.cuda.get_device_name(0)
    # (a) card and kernel build
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else 'nvidia-smi unavailable'
    print(card, flush=True)
    say('a', 'torch %s cuda %s, %s x%d, card: %s' % (
        torch.__version__, torch.version.cuda, kind,
        torch.cuda.device_count(), card))
    native_cuda.load('cand_screen.cu')
    say('a', 'cand_screen.cu built in %.2fs (nvcc sm_90a); ptxas: %s' % (
        native_cuda.build_seconds['cand_screen.cu'],
        ' | '.join(l.strip() for l in native_cuda.ptxas_report.get(
            'cand_screen.cu', '').splitlines()
            if 'registers' in l or 'spill' in l)))

    suites = bench.load_mtbc()
    windows = bench.template_windows(suites)
    from kvarq_tpu_torch.analyse import Analyser
    covs = Analyser().load_coverages(suites, spacing=25)
    seqs = [c.plus_seq.bases for c in covs.values()]
    seqs += [c.minus_seq.bases for c in covs.values()]
    t0 = time.time()
    path, prefix = corpus(windows)
    say('setup', 'corpus %s (%d reads x %d bp, %.0f MB) ready in %.1fs; '
        '%d templates' % (os.path.basename(path), N_READS, READLEN,
                          os.path.getsize(path) / 1e6, time.time() - t0,
                          len(seqs)))

    # (b) K1 against its plain version on one real main-path batch
    stats = reader.ReaderStats()
    batch = next(iter(reader.batches([path], ord(SCAN['Amin']),
                                     SCAN['minreadlength'], stats,
                                     batchsize=MAIN_B, nthreads=8)))
    B, Lpad = batch.codes.shape
    bank = tts.build_bank(seqs, Lpad, SCAN['minoverlap'])
    state = tps.device_arrays(bank, len(seqs), dev)
    codes = torch.from_numpy(batch.codes).to(dev)
    rl = torch.from_numpy(batch.rl.astype(np.int32)).to(dev)
    e, mo = SCAN['maxerrors'], SCAN['minoverlap']
    got = tps.cand_counts(codes, rl, state, e, mo, state.nch)
    want = tps.cand_counts_ref(codes, rl, state, e, mo, state.nch)
    torch.cuda.synchronize()
    err = int((got - want).abs().max())
    check(err == 0, 'K1 differs from cand_counts_ref at the main-path shape '
          '(max abs err %d)' % err)
    k_ms = cuda_time_ms(
        lambda: tps.cand_counts(codes, rl, state, e, mo, state.nch))
    ref_ms = cuda_time_ms(
        lambda: tps.cand_counts_ref(codes, rl, state, e, mo, state.nch))
    say('b', 'K1 == cand_counts_ref exactly at B=%d Lpad=%d G=%d Q=%d Qp=%d '
        'nch=%d (%d candidates); kernel %.3f ms, plain %.3f ms (median of 5)'
        % (B, Lpad, bank.G, bank.Q, state.Qp, state.nch,
           int((got > 0).sum()), k_ms, ref_ms))

    rng = np.random.RandomState(5)
    nbank = [''.join(rng.choice(list('ACGTN'), rng.randint(30, 300)))
             for _ in range(40)]
    bank5 = tts.build_bank(nbank, 128, 10)
    state5 = tps.device_arrays(bank5, len(nbank), dev)
    check(state5.nch == 5, '5-channel bank expected')
    lut = np.full(256, 5, dtype=np.uint8)
    lut[np.frombuffer(b'ACGTN', np.uint8)] = np.arange(5)
    raw = rng.randint(0, 5, (3000, 128)).astype(np.uint8)
    for i in range(0, 3000, 3):      # plant template pieces
        s = lut[np.frombuffer(nbank[rng.randint(40)].encode(), np.uint8)]
        off = rng.randint(0, 100)
        raw[i, off:off + len(s)] = s[:128 - off]
    rl5 = rng.randint(0, 129, 3000).astype(np.int32)
    raw[np.arange(128)[None, :] >= rl5[:, None]] = 5
    c5, r5 = torch.from_numpy(raw).to(dev), torch.from_numpy(rl5).to(dev)
    for e5, mo5 in ((0, 25), (3, 8)):
        got5 = tps.cand_counts(c5, r5, state5, e5, mo5, 5)
        want5 = tps.cand_counts_ref(c5, r5, state5, e5, mo5, 5)
        err5 = int((got5 - want5).abs().max())
        check(err5 == 0, 'K1 differs on the 5-channel bank (e=%d)' % e5)
        check(int((want5 > 0).sum()) > 0, 'no candidates on the 5-channel bank')
        say('b', 'K1 == cand_counts_ref exactly on a 5-channel bank (B=%d, '
            'Qp=%d, e=%d, mo=%d, %d candidates); kernel %.3f ms, plain %.3f ms'
            % (len(raw), state5.Qp, e5, mo5, int((got5 > 0).sum()),
               cuda_time_ms(lambda: tps.cand_counts(c5, r5, state5, e5, mo5,
                                                    5)),
               cuda_time_ms(lambda: tps.cand_counts_ref(c5, r5, state5, e5,
                                                        mo5, 5))))
    del codes, rl, got, want, c5, r5, state5

    # (d) oracle gate on the first 8192 reads, both sieve modes (this also
    # warms the port's engine before the timed scans)
    found = None
    for sieve in ('off', 'auto'):
        engine.config(device='cuda', sieve=sieve, **SCAN)
        ret = engine.countseqs(prefix, seqs)
        found = oracle_gate(ret, prefix, seqs, found)
        say('d', 'sieve=%s: bit-exact vs the numpy oracle on the first %d '
            'reads (%d template hits)' % (sieve, ret['stats']['records_parsed'],
                                          sum(ret['stats']['nseqhits'])))

    # (c) the main path over the corpus: unsieved (K1) and sieved (dense)
    rows = tts.score_rows(dev, state.Qp)
    results = {}
    for sieve in ('off', 'auto'):
        engine.config(device='cuda', sieve=sieve, **SCAN)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        if sieve == 'off':
            tps.cand_counts.launches = 0
        t0 = time.time()
        ret = engine.countseqs(path, seqs)
        torch.cuda.synchronize()
        dt = time.time() - t0
        if sieve == 'off':
            launches = tps.cand_counts.launches
            check(launches > 0, 'the unsieved scan never launched K1')
        nrec = ret['stats']['records_parsed']
        check(nrec == N_READS, 'parsed %d of %d records' % (nrec, N_READS))
        results[sieve] = ret
        say('c', 'sieve=%s: %d reads in %.3fs = %.1f reads/s, %d template '
            'hits, peak device memory %.2f GB, steps of %d-read batches '
            'scored in passes of <= %d reads%s' % (
                sieve, nrec, dt, nrec / dt, sum(ret['stats']['nseqhits']),
                torch.cuda.max_memory_allocated() / 1e9, MAIN_B, rows,
                ', K1 launches %d' % launches if sieve == 'off' else ''))
    for a, b in zip(results['off']['basecounts'],
                    results['auto']['basecounts']):
        check(np.array_equal(a, b), 'sieve on/off basecounts differ')
    check(results['off']['stats'] == results['auto']['stats'],
          'sieve on/off stats differ')
    check(sum(results['off']['stats']['nseqhits']) > 0, 'no hits in corpus')
    say('c', 'sieve on and off agree bit for bit (basecounts and stats)')

    # breakdown: the host input layer alone, then the scanner alone on the
    # batches it produced (held in host memory)
    for sieve in ('off', 'auto'):
        engine.config(device='cuda', sieve=sieve, **SCAN)
        t0 = time.time()
        held = [(b.codes, b.rl) for b in reader.batches(
            [path], ord(SCAN['Amin']), SCAN['minreadlength'],
            reader.ReaderStats(), batchsize=16384, nthreads=8,
            sieve=engine._make_sieve(seqs))]
        t_read = time.time() - t0
        sc = tts.TensorScanner(seqs, SCAN['maxerrors'], SCAN['minoverlap'],
                               dev)
        if sieve == 'auto':
            sc.assume_dense()
        sc._context(held[0][0].shape[1])       # bank set-up, untimed
        torch.cuda.synchronize()
        t0 = time.time()
        for c, r in held:
            sc.scan_batch(reader.RecordBatch(c, r, None, None))
        sc.finalize()
        torch.cuda.synchronize()
        t_dev = time.time() - t0
        say('c', 'breakdown sieve=%s: reader%s alone %.3fs (%d reads passed '
            'in %d batches); scanner alone %.3fs (gather_k ends at %d, '
            'scoring passes of <= %d reads)' % (
                sieve, '+sieve' if sieve == 'auto' else '', t_read,
                sum(len(r) for _, r in held), len(held), t_dev, sc.gather_k,
                next(iter(sc._ctx.values()))['rows']))
        del held, sc

    # where the time goes: one scan per mode under torch.profiler (its
    # wall time includes the profiler's own cost)
    for sieve in ('off', 'auto'):
        engine.config(device='cuda', sieve=sieve, **SCAN)
        wall, busy, k1, top = traced_scan(engine, path, seqs)
        if busy == 0:
            say('trace', 'sieve=%s: wall %.3fs; kernel time not measured '
                '(the profiler saw no device activity)' % (sieve, wall))
            continue
        say('trace', 'sieve=%s: wall %.3fs, kernel time on the card %.3fs '
            '(%.1f%% busy), K1 %.3fs; longest: %s' % (
                sieve, wall, busy, 100 * busy / wall, k1,
                '; '.join('%s %.1f ms' % kv for kv in top)))

    # (e) CLI golden runs against kvarq_tpu's numpy hit path
    for name, (extra, calls) in GOLDEN.items():
        fq = os.path.join('tests', 'fastqs', name)
        refj = os.path.join(WORK, name + '.ref.json')
        run([sys.executable, '-m', 'kvarq_tpu.cli', '-q', '-t', 'testsuites',
             'scan', '-f', '-l', 'MTBC', '--backend', 'numpy', '-H', *extra,
             fq, refj])
        ref = json.load(open(refj))
        for sieve in ('off', 'auto'):
            outj = os.path.join(WORK, '%s.%s.json' % (name, sieve))
            run([sys.executable, '-m', 'kvarq_tpu_torch.cli', '-q', '-t',
                 'testsuites', 'scan', '-f', '-l', 'MTBC', *extra, fq, outj],
                env={'KVARQ_SIEVE': sieve})
            text = run([sys.executable, '-m', 'kvarq_tpu_torch.cli', '-q',
                        '-t', 'testsuites', 'illustrate', '-r', outj])
            for call in calls:
                check(call in text, '%s sieve=%s: missing %r' % (name, sieve,
                                                                 call))
            out = json.load(open(outj))
            for key in ('coverages', 'analyses', 'stats'):
                check(out[key] == ref[key], '%s sieve=%s: %s differ from the '
                      'numpy hit path' % (name, sieve, key))
        say('e', '%s: golden calls present, coverages/analyses/stats equal '
            'the numpy hit path (sieve off and on)' % name)

    # (f) summary
    say('f', 'peak device memory of this process %.2f GB; total %.1fs' % (
        torch.cuda.max_memory_allocated() / 1e9, time.time() - t_start))
    print(json.dumps({'kernels': [{
        'name': 'cand_screen', 'route': 'cuda',
        'source': 'kvarq_tpu_torch/csrc/cand_screen.cu',
        'replaces': 'kvarq_tpu/engine/pallas_scan.py:151',
        'launches': launches, 'max_abs_err': err, 'ms': k_ms,
        'plain_ms': ref_ms}]}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print('FAIL: %s' % e, flush=True)
        sys.exit(1)
