#!/usr/bin/env python3
'''
Smoke run of kvarq_tpu_torch on one NVIDIA GPU: builds the CUDA kernels
(the candidate screen K1, and the exact scoring S1 with the hit
extraction H1 in one source, all three on one pipeline: one nvcc per
source, at the same time) from this checkout, checks each against its
plain PyTorch version at the main-path shapes and times it beside its
bound (K1 with the fp16 and int8 one-hot products alone as context; S1
dense, gathered and above gather_k, with its phase split; H1 dense and
gathered as sorted triplet sets),
drives ``kvarq scan``'s coverage path (``countseqs``)
and its hit-list path (``findseqs``, ``scan -H/-x``) over the 2M-read
bench corpus with and without the k-mer sieve and over a hit-dense
corpus, gates the results against the numpy oracle and against each
other, runs the scanner over the corpus with no host round trip between
flushes (``torch.cuda.set_sync_debug_mode('error')``), runs the CLI on
the golden MTBC fixtures (timing each process on
the card, on the CPU and with the numpy and auto backends, and a cold
process on the card in parts; auto on the corpus), the scale-out layer
(h), the GUI's scan, stop, save and explorers headless through
tests/faketk.py (i), the entry points of graft_entry.py and the two
device tools (j), the hitdiff sweep against the C reference on the card
and with the numpy backend (k), and the corpus with a second mate as a
gzipped, BGZF and plain paired FastQ through the CLI (l).

    python3 chip_smoke.py

Every phase prints lines of its own; any failure exits non-zero before
the result lines.  The ``[trace]`` lines time one scan per sieve mode under
torch.profiler (kernel time on the card, its busy share, K1's and
S1's time, the top kernels).  The last two lines are the kernel table
(with each kernel's launch count on each path) and ``{"ok": true,
"device": {...}}``.  Work
files go to build/kvarq_tpu_torch/smoke/.
'''

import concurrent.futures
import faulthandler
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

# with nothing of the repo beside this file, this import fails (exit 1)
from kvarq_tpu_torch.tools.s1_bench import cuda_time_ms, ptxas_summary

HERE = os.path.abspath(os.path.dirname(__file__))
WORK = os.path.join(HERE, 'build', 'kvarq_tpu_torch', 'smoke')
N_READS = 2000000
READLEN = 101
MATE_SEED = 20260818    # the second file of phase (l)'s pair
# the hit-dense corpus: half the reads planted from template loci
DENSE_READS = 262144
DENSE_PLANT = 0.5
MAIN_B = 16384      # reads per batch, as the engine's default batchsize
GATHER_K = 768      # the scanner's first gather_k (tensor_scan)
ABOVE_K = 128       # a gather_k below a batch's candidates
# CLI defaults (kvarq_tpu_torch/config.py): e=2, o=25, r=25, Q13 on Sanger
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


# the fixture whose CLI runs in (e) are timed as cold processes
COLD_FIXTURE = 'N0116_1_hits_1k.fastq'
# the engine's -d log lines of the two paths of --backend auto
SMALL_LOG = 'small input: scanning via the numpy hit path'
AUTO_DEVICE_LOG = 'backend auto: scanning on cuda'


# no phase may take longer: past it, every thread's traceback is printed
# and the run exits with 1 (a hung phase must not outlive the run's limit)
PHASE_SECONDS = 420


class SmokeFailure(Exception):
    pass


# the sources of the port's kernels, built at the same time in (a)
KERNEL_SOURCES = ['cand_screen.cu', 'score_step.cu']
# S1's and H1's launches per path (``by_path`` holds K1's); the coverage
# paths score through S1, the hit paths extract through H1
S1_BY_PATH = {}
H1_BY_PATH = {}
# a hit cell's peak device memory must stay below this (bytes): H1 holds
# nothing of size [B, Qp]
HIT_PEAK_LIMIT = 1e9


def zero_launches(tps):
    ''' every kernel's launch count to 0, just before a path is driven '''
    tps.cand_counts.launches = 0
    tps.score_candidates.launches = 0
    tps.hit_triplets.launches = 0


def stamp(stamps, phase):
    ''' the start of ``phase``: its time into ``stamps``, the watchdog
        re-armed '''
    stamps.append((phase, time.time()))
    faulthandler.dump_traceback_later(PHASE_SECONDS, exit=True)


def check(ok, msg):
    if not ok:
        raise SmokeFailure(msg)


def say(phase, msg):
    print('[%s] %s' % (phase, msg), flush=True)


def k1_phase(tps, codes, rl, state, e, mo, bank, card):
    '''
    phase (b), K1 on the main-path batch against its plain version
    (``cand_counts_ref``), exactly (``tools/s1_bench.py`` ``measure_k1``):
    timed with CUDA events, median of 5, in turns plain, kernel, kernel,
    plain, and under the profiler (the kernel alone), beside its bound and,
    as context, the fp16 and int8 one-hot products alone.

    :returns: measure_k1's entry
    '''
    from kvarq_tpu_torch.tools import s1_bench
    try:
        out = s1_bench.measure_k1(tps, codes, rl, state, e, mo)
    except AssertionError as err:
        raise SmokeFailure('%s at the main-path shape' % err)
    check(out['candidates'] > 0, 'K1: no candidates on the main-path batch')
    check(out['int_mm_ms'] is not None, 'torch._int_mm refused the int8 '
          'product: %s' % out['int_mm_error'])
    say('b', 'K1 == cand_counts_ref exactly at B=%d Lpad=%d G=%d Q=%d Qp=%d '
        'nch=%d; %s; %s' % (codes.shape[0], codes.shape[1], bank.G, bank.Q,
                            state.Qp, state.nch, s1_bench.describe_k1(out),
                            card))
    return out


def s1_phase(tps, native_cuda, codes, rl, state, e, mo, mm_ms, card):
    '''
    phase (b), S1 on the main-path batch against its plain version
    (``score_candidates_ref``), exactly, in its forms
    (``tools/s1_bench.py``): ``dense`` (every read: the step of the sieved
    main path), ``gathered`` (the reads K1 flags, compacted on the card:
    the unsieved step) and ``above_gather_k`` (the same rows, as the step
    whose count is above its gather_k scores them: one launch shape with
    ``gathered``, since the kernel's grid does not depend on the count).
    Each is timed with CUDA events, median of 5, in turns plain, kernel,
    kernel, plain, and under the profiler (the kernel alone), beside its
    bound, with the phase split of its profile buffer.

    :returns: ``{form: s1_bench.measure's entry, 'max_abs_err': 0}``
    '''
    from kvarq_tpu_torch.tools import s1_bench
    say('b', 'ptxas -v of score_step.cu: %s' % ptxas_summary(
        native_cuda.ptxas_report.get('score_step.cu', '')))
    try:
        out = s1_bench.measure(tps, codes, rl, state, e, mo)
    except AssertionError as err:
        raise SmokeFailure('%s at the main-path shape' % err)
    n = out['gathered']['rows']
    check(ABOVE_K < n <= GATHER_K, 'the main-path batch has %d candidates, '
          'not in (%d, %d]' % (n, ABOVE_K, GATHER_K))
    for form, r in out.items():
        check(r['hit_weight'] > 0, 'S1 %s: no hit weight' % form)
        say('b', 'S1 == score_candidates_ref exactly, %s; the fp16 '
            'torch.matmul of the dense product alone %.3f ms (context); %s'
            % (s1_bench.describe(form, r), mm_ms, card))
    out['max_abs_err'] = 0
    return out


def h1_phase(tps, codes, rl, state, e, mo, mm_ms, n_cand, card):
    '''
    phase (b), H1 on the main-path batch against its plain version
    (``hit_triplets_ref``), exactly, as sorted triplet sets
    (``tools/s1_bench.py`` ``measure_hits``): ``dense`` (every read) and
    ``gathered`` (the reads K1 flags, compacted on the card: the hit
    path's step), timed with CUDA events, median of 5, in turns plain,
    kernel, kernel, plain, and under the profiler, beside its bound.

    :returns: ``{form: measure_hits' entry}``
    '''
    from kvarq_tpu_torch.tools import s1_bench
    try:
        out = s1_bench.measure_hits(tps, codes, rl, state, e, mo)
    except AssertionError as err:
        raise SmokeFailure('%s at the main-path shape' % err)
    check(out['gathered']['rows'] == n_cand, 'H1 gathered %d rows, K1 flags '
          '%d' % (out['gathered']['rows'], n_cand))
    for form, r in out.items():
        check(r['triplets'] > 0, 'H1 %s: no triplets' % form)
        say('b', 'H1 == hit_triplets_ref exactly (sorted triplet sets), %s; '
            'the fp16 torch.matmul of the dense product alone %.3f ms '
            '(context); %s' % (s1_bench.describe_hits(form, r), mm_ms, card))
    return out


def no_sync_gate(tps, tts, reader, dev, seqs, held, want, card):
    '''
    phase (c): the scanner over the corpus's unsieved batches (``held``,
    host arrays) with no host round trip between flushes.  Every step runs
    under ``torch.cuda.set_sync_debug_mode('error')``, where a host read of
    a device value raises: dense (S1 on every batch) and gathered (K1,
    compaction on the card, S1 on the candidates).  The flushes, and the
    gathered scanner's first step (its one peek at the count), run outside
    that mode.  Both equal ``want`` (the unsieved ``countseqs`` of (c)) bit
    for bit.  Then one step whose count is above its gather_k (128) runs
    under the mode and equals the dense step.
    '''
    import torch
    check(len(held) >= 64, 'only %d batches in the corpus' % len(held))
    e, mo = SCAN['maxerrors'], SCAN['minoverlap']
    Lpad = held[0][0].shape[1]
    for mode in ('dense', 'gathered'):
        sc = tts.TensorScanner(seqs, e, mo, dev)
        if mode == 'dense':
            sc.assume_dense()
        sc._context(Lpad)
        batches = [reader.RecordBatch(c, r, None, None) for c, r in held]
        if mode == 'gathered':
            sc.scan_batch(batches.pop(0))
        flush = sc._flush

        def unchecked(*a, flush=flush, **kw):
            prev = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode(0)
            try:
                return flush(*a, **kw)
            finally:
                torch.cuda.set_sync_debug_mode(prev)
        sc._flush = unchecked
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_launches(tps)
        t0 = time.time()
        torch.cuda.set_sync_debug_mode('error')
        try:
            for batch in batches:
                sc.scan_batch(batch)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        sc.finalize()
        torch.cuda.synchronize()
        dt = time.time() - t0
        k1n, s1n = tps.cand_counts.launches, tps.score_candidates.launches
        # a batch not above gather_k (the last) is scored densely
        check(s1n == len(batches) and (0 < k1n <= s1n if mode == 'gathered'
                                       else k1n == 0),
              '%s steps: %d batches, S1 launches %d, K1 %d'
              % (mode, len(batches), s1n, k1n))
        for t, (a, b) in enumerate(zip(sc.coverages(), want['basecounts'])):
            check(np.array_equal(a, b), '%s steps with no sync: basecounts'
                  '[%d] differ from countseqs sieve=off' % (mode, t))
        check(sc.seqhits.tolist() == list(want['stats']['nseqhits'])
              and sc.seqbasehits.tolist()
              == list(want['stats']['nseqbasehits']),
              '%s steps with no sync: seqhits differ from countseqs '
              'sieve=off' % mode)
        say('c', 'no host round trip: %d %s steps of %d reads under '
            'set_sync_debug_mode("error") (S1 launches %d, K1 %d; flushes%s '
            'outside it) in %.3fs, gather_k ends at %d, peak device memory '
            '%.2f GB; basecounts, seqhits and seqbasehits equal countseqs '
            'sieve=off bit for bit; %s' % (
                len(batches), mode, MAIN_B, s1n, k1n,
                ' and the first step' if mode == 'gathered' else '', dt,
                sc.gather_k, torch.cuda.max_memory_allocated() / 1e9, card))
    state = sc._ctx[Lpad]['state']
    c = torch.from_numpy(held[0][0]).to(dev)
    r = torch.from_numpy(held[0][1].astype(np.int32)).to(dev)
    dense = tps.scan_step_banked(c, r, state, e, mo, 0)
    torch.cuda.synchronize()
    zero_launches(tps)
    torch.cuda.set_sync_debug_mode('error')
    try:
        over = tps.scan_step_banked(c, r, state, e, mo, ABOVE_K)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    n = int(over[3])
    check(n > ABOVE_K and tps.score_candidates.launches == 1
          and tps.cand_counts.launches == 1, 'the step above gather_k: %d '
          'candidates, S1 %d and K1 %d launches' % (
              n, tps.score_candidates.launches, tps.cand_counts.launches))
    for what, a, b in zip(('basecount', 'seqhits', 'seqbasehits'), over,
                          dense):
        check(torch.equal(a, b), 'the step above gather_k: %s differs from the '
              'dense step' % what)
    say('c', 'one step with gather_k %d and %d candidates under '
        'set_sync_debug_mode("error"): S1 covers every candidate (its blocks '
        'grid does not depend on the count), equal to the dense step bit for '
        'bit' % (ABOVE_K, n))


def run(cmd, env=None, timeout=300, seconds=None, stderr=False):
    ''' run ``cmd`` from the checkout's root; its wall seconds, process
        start included, go into the list ``seconds`` when given.
        :returns: its standard output, with ``stderr`` (stdout, stderr) '''
    t0 = time.time()
    proc = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True,
                          timeout=timeout, env=dict(os.environ, **(env or {})))
    if seconds is not None:
        seconds.append(time.time() - t0)
    check(proc.returncode == 0, '%s exited %d:\n%s'
          % (' '.join(cmd), proc.returncode, proc.stderr[-4000:]))
    return (proc.stdout, proc.stderr) if stderr else proc.stdout


def cli_main(args, sieve='auto'):
    ''' ``cli.main(args)`` in this process, with the engine's sieve set to
        ``sieve``; the engine is put back on the card's device path after.
        :returns: its standard output '''
    import contextlib
    import io
    from kvarq_tpu_torch import cli, engine
    out = io.StringIO()
    engine.config(sieve=sieve)
    try:
        with contextlib.redirect_stdout(out):
            cli.main(list(args))
    except SystemExit as e:
        raise SmokeFailure('cli %s exited %s' % (' '.join(args), e.code))
    finally:
        engine.config(sieve='auto', backend='device', device='cuda', mesh='')
    return out.getvalue()


def cli_scan(args, process=False, sieve='auto', seconds=None):
    ''' ``kvarq scan``-like CLI ``args``: in a process of its own (its wall
        seconds into ``seconds``) or in this one '''
    if process:
        return run([sys.executable, '-m', 'kvarq_tpu_torch.cli'] + list(args),
                   env={'KVARQ_SIEVE': sieve}, seconds=seconds)
    return cli_main(args, sieve)


# the CLI (``cli.main``) in a process that prints the CUDA kernel's
# launches as its last line
COUNTED_CLI = r'''
import json
import sys

from kvarq_tpu_torch import cli
from kvarq_tpu_torch.engine import pallas_scan

cli.main(sys.argv[1:])
print(json.dumps({'cand_launches': pallas_scan.cand_counts.launches,
                  'score_launches': pallas_scan.score_candidates.launches}))
'''


def counted_cli(args, env=None, seconds=None, stderr=False):
    ''' ``python -m kvarq_tpu_torch.cli`` with ``args`` through
        COUNTED_CLI: (K1 launches, its stderr when ``stderr``) '''
    out, err = run([sys.executable, '-c', COUNTED_CLI] + list(args), env=env,
                   seconds=seconds, stderr=True)
    n = json.loads(out.strip().splitlines()[-1])['cand_launches']
    return (n, err) if stderr else n


# a cold CLI process on the card, timed in parts: ``import torch``, the CUDA
# context, the kernel libraries' load (built already), the CLI's imports, its
# testsuite load, and the rest of its run (scan, analyses, json); printed
# as a JSON line
COLD_PARTS = r'''
import json
import sys
import time

parts = {}
t = time.time()
import torch
parts['import torch'] = time.time() - t
t = time.time()
torch.cuda.init()
torch.empty(1, device='cuda')
torch.cuda.synchronize()
parts['CUDA context'] = time.time() - t
t = time.time()
from kvarq_tpu_torch.engine import native_cuda
native_cuda.load_all(['cand_screen.cu', 'score_step.cu'])
parts['kernel libraries load'] = time.time() - t
t = time.time()
from kvarq_tpu_torch import cli
parts['CLI imports'] = time.time() - t
selected = cli._selected_testsuites


def timed(args):
    t = time.time()
    suites = selected(args)
    parts['testsuite load'] = time.time() - t
    return suites


cli._selected_testsuites = timed
t = time.time()
cli.main(sys.argv[1:])
parts['scan, analyses, json'] = time.time() - t - parts['testsuite load']
print(json.dumps(parts))
'''


def corpus(seqs_windows, n_reads=N_READS, plant=None):
    ''' a bench corpus (kvarq_tpu_torch.bench.generate_fastq, seed
        20260817; ``plant`` overrides bench.PLANT_FRAC) and its first 8192
        reads '''
    from kvarq_tpu_torch import bench
    os.makedirs(WORK, exist_ok=True)
    tag = 'mtbc_%dx%d%s' % (n_reads, READLEN,
                            '_p%g' % plant if plant is not None else '')
    path = os.path.join(WORK, tag + '.fastq')
    prefix = os.path.join(WORK, tag + '_prefix_8192.fastq')
    if not os.path.exists(path):
        bench.generate_fastq(path + '.tmp', seqs_windows, n_reads, READLEN,
                             plant=plant)
        os.replace(path + '.tmp', path)
    with open(path) as f, open(prefix, 'w') as g:
        for _ in range(4 * 8192):
            g.write(f.readline())
    return path, prefix


def traced_scan(scan, path, seqs):
    ''' one scan (``countseqs`` or ``findseqs``) under torch.profiler:
        (wall s, kernel s on the card, K1 s, S1 s, H1 s, [(kernel, ms)] of
        the five longest) '''
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        scan(path, seqs)
        torch.cuda.synchronize()
        wall = time.time() - t0
    dev = sorted((e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA),
                 key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in dev) / 1e6
    k1, s1, h1 = (sum(e.self_device_time_total for e in dev
                      if name in e.key) / 1e6
                  for name in ('cand_screen_kernel', 'score_step_kernel',
                               'hit_extract_kernel'))
    return wall, busy, k1, s1, h1, [
        (e.key[:48], e.self_device_time_total / 1e3) for e in dev[:5]]


def oracle_gate(ret, prefix, seqs, found):
    ''' bench.assert_device_matches_oracle: the port engine, configured
        like the scan, with the byte-exact numpy matcher of its
        match_numpy '''
    from kvarq_tpu_torch import bench
    try:
        return bench.assert_device_matches_oracle(ret, prefix, seqs,
                                                  found=found)
    except SystemExit as e:
        raise SmokeFailure(str(e))


class Timed:
    ''' a callable's wrapper that sums the wall seconds spent in it '''

    def __init__(self, fn):
        self.fn = fn
        self.seconds = 0.0

    def __call__(self, *args, **kwargs):
        t0 = time.time()
        try:
            return self.fn(*args, **kwargs)
        finally:
            self.seconds += time.time() - t0


def timed_findseqs(engine, path, seqs, made=None):
    ''' one findseqs with the seconds in the matcher (screen, compaction,
        extraction, triplet readback: its result is on the host) and in
        the host's ``_emit``; resets the peak device memory first.  The
        matchers built go into ``made`` when given.
        :returns: (result, wall s, matcher s, _emit s) '''
    import torch
    emit, make = Timed(engine._emit), engine._make_matcher
    matchers = []

    def make_timed(seqs_):
        m = make(seqs_)
        m.match_batch = Timed(m.match_batch)
        matchers.append(m.match_batch)
        if made is not None:
            made.append(m)
        return m

    engine._emit, engine._make_matcher = emit, make_timed
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        found = engine.findseqs(path, seqs)
        torch.cuda.synchronize()
        wall = time.time() - t0
    finally:
        engine._emit, engine._make_matcher = emit.fn, make
    return found, wall, sum(m.seconds for m in matchers), emit.seconds


def hits_gate(found, counted, seqs, what):
    ''' a findseqs result replays into the countseqs result of the same
        input: equal stats, and bench.oracle_basecounts of the hit list
        equals the basecounts '''
    from kvarq_tpu_torch import bench
    check(found['stats'] == counted['stats'],
          '%s: findseqs and countseqs stats differ' % what)
    for t, (got, want) in enumerate(zip(bench.oracle_basecounts(found, seqs),
                                        counted['basecounts'])):
        check(np.array_equal(got, want), '%s: basecounts[%d] of the hit list '
              'differ from countseqs' % (what, t))


def numpy_oracle(engine, path, seqs):
    ''' the byte-exact numpy findseqs of the port, configured like the
        scan '''
    from kvarq_tpu_torch import bench
    engine.config(**SCAN)
    return bench.numpy_findseqs(path, seqs)


def countseqs_with_scanner(engine, path, seqs):
    ''' one countseqs: (result, wall s, the scanner it built); resets the
        peak device memory first '''
    import torch
    make = engine._make_scanner
    made = []

    def make_kept(seqs_):
        made.append(make(seqs_))
        return made[-1]

    engine._make_scanner = make_kept
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        ret = engine.countseqs(path, seqs)
        torch.cuda.synchronize()
        wall = time.time() - t0
    finally:
        engine._make_scanner = make
    return ret, wall, made[0]


def split_corpus(path, n_first):
    ''' the corpus as two files: its first ``n_first`` records, the rest '''
    parts = [path[:-len('.fastq')] + '_part%d.fastq' % k for k in (1, 2)]
    if not all(os.path.exists(p) for p in parts):
        with open(path, 'rb') as f:
            for _ in range(4 * n_first):
                f.readline()
            cut = f.tell()
            f.seek(0)
            for p, data in zip(parts, (f.read(cut), f.read())):
                with open(p + '.tmp', 'wb') as g:
                    g.write(data)
                os.replace(p + '.tmp', p)
    return parts


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


# one process of phase (h)'s two-process run: scan_sharded over its share
# of the files in the Gloo group named by KVARQ_COORDINATOR,
# KVARQ_NUM_PROCESSES and KVARQ_PROCESS_ID, on its share of the host's
# cards (both on the one card of a one-card host)
SHARDED_WORKER = r'''
import json
import sys

import numpy as np

from kvarq_tpu_torch.engine import pallas_scan, reader
from kvarq_tpu_torch.parallel import multihost

out, params, seqs_path, files = sys.argv[1], sys.argv[2], sys.argv[3], \
    sys.argv[4:]
rank, world = multihost.initialize()
with open(seqs_path) as f:
    seqs = f.read().split()
stats = reader.ReaderStats()
covs, sh, sbh = multihost.scan_sharded(files, seqs, stats=stats,
                                       **json.loads(params))
np.savez(out, bc=np.concatenate([c.ravel() for c in covs]), sh=sh, sbh=sbh,
         rls=stats.rls, counts=np.asarray([
             stats.records_parsed, stats.parsed, stats.total,
             stats.rls_longest]),
         world=world, launches=pallas_scan.cand_counts.launches,
         score_launches=pallas_scan.score_candidates.launches)
'''


def two_processes(parts, seqs):
    ''' SHARDED_WORKER in two processes on this host: (their two results,
        wall s); both are killed if either fails or 300 s pass '''
    os.makedirs(WORK, exist_ok=True)
    wpath = os.path.join(WORK, 'sharded_worker.py')
    spath = os.path.join(WORK, 'sharded_seqs.txt')
    with open(wpath, 'w') as f:
        f.write(SHARDED_WORKER)
    with open(spath, 'w') as f:
        f.write('\n'.join(seqs))
    env = dict(os.environ, KVARQ_COORDINATOR='localhost:%d' % free_port(),
               KVARQ_NUM_PROCESSES='2', PYTHONPATH=os.pathsep.join(
                   [HERE] + [p for p in [os.environ.get('PYTHONPATH')] if p]))
    outs = [os.path.join(WORK, 'sharded_%d.npz' % i) for i in range(2)]
    logs = [os.path.join(WORK, 'sharded_%d.log' % i) for i in range(2)]
    procs = []
    t0 = time.time()
    try:
        for i in range(2):
            with open(logs[i], 'w') as log:
                procs.append(subprocess.Popen(
                    [sys.executable, wpath, outs[i], json.dumps(SCAN), spath,
                     *parts], cwd=HERE, stdout=log, stderr=subprocess.STDOUT,
                    env=dict(env, KVARQ_PROCESS_ID=str(i))))
        while time.time() - t0 < 300 and any(p.poll() is None for p in procs) \
                and not any(p.poll() for p in procs):
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    wall = time.time() - t0
    for i, p in enumerate(procs):
        with open(logs[i]) as f:
            check(p.returncode == 0, 'scan_sharded process %d exited %s:\n%s'
                  % (i, p.returncode, f.read()[-4000:]))
    return [dict(np.load(o)) for o in outs], wall


def shard_screen_gate(tps, bank, entries, params):
    '''
    K1 against ``cand_counts_ref`` on the bank shards of ``bank`` (a
    ``parallel.ShardBank``), exactly: for every ``(what, j, codes, rl)`` of
    ``entries`` (card tensors) and every ``(e, mo)`` of ``params``, K1 runs
    against shard ``j``'s state on the card of ``codes``.  Every shard must
    get candidates.

    :returns: ``[(what, j, rows, candidates, kernel ms, plain ms)]``, one
        per entry, the times of its first ``(e, mo)``
    '''
    out = []
    found = np.zeros(bank.n_bank, dtype=np.int64)
    for what, j, codes, rl in entries:
        state = bank.state(j, codes.device)
        n = 0
        for e, mo in params:
            got = tps.cand_counts(codes, rl, state, e, mo, state.nch)
            want = tps.cand_counts_ref(codes, rl, state, e, mo, state.nch)
            err = int((got - want).abs().max())
            check(err == 0, 'K1 differs from cand_counts_ref on bank shard '
                  '%d (B=%d, G=%d, Qp=%d, nch=%d, e=%d, mo=%d; max abs err '
                  '%d)' % (j, len(codes), bank.G, bank.Qp, state.nch, e, mo,
                           err))
            n += int((want > 0).sum())
        found[j] += n
        e, mo = params[0]
        out.append((what, j, len(codes), n, cuda_time_ms(
            lambda: tps.cand_counts(codes, rl, state, e, mo, state.nch)),
            cuda_time_ms(lambda: tps.cand_counts_ref(codes, rl, state, e, mo,
                                                     state.nch))))
    check((found > 0).all(), 'a bank shard got no candidate: %s'
          % found.tolist())
    return out


def revcomp_codes(codes, rl):
    ''' the reverse complements of rows of read codes, each within its read
        length (A<->T, C<->G; N and junk stay) '''
    comp = np.arange(256, dtype=np.uint8)
    comp[:4] = [3, 2, 1, 0]
    out = codes.copy()
    for k, n in enumerate(rl):
        out[k, :n] = comp[codes[k, :n][::-1]]
    return out


def sharded_arrays(covs, sh, sbh, stats):
    return dict(bc=np.concatenate([c.ravel() for c in covs]), sh=sh, sbh=sbh,
                rls=stats.rls, counts=np.asarray([
                    stats.records_parsed, stats.parsed, stats.total,
                    stats.rls_longest]))


def scale_out(engine, tps, seqs, path, results, hit_off, by_path):
    '''
    phase (h): kvarq_tpu_torch.parallel against the single-device results
    of phases (c), (g) and (e), bit for bit.  The meshes repeat a card
    when the host has fewer than four.

    - ``countseqs`` on a 2x2 mesh over the corpus, sieve off (K1 on every
      entry) and on (dense, no K1), against (c); K1 against
      ``cand_counts_ref`` on that scan's bank-shard states, exactly;
    - ``findseqs`` on a 1x2 mesh, sieve off, against (g)'s hit stream;
    - ``batch`` (the CLI) over the corpus split in two, against ``scan``
      of the whole corpus; ``batch --per-sample`` on the golden fixtures
      against (e)'s ``scan`` results;
    - ``multihost.scan_sharded`` in two processes (Gloo over localhost)
      against one process and (c).
    '''
    import torch
    from kvarq_tpu_torch import parallel
    from kvarq_tpu_torch.engine import reader
    from kvarq_tpu_torch.parallel import multihost

    ncards = torch.cuda.device_count()
    cards = ['cuda:%d' % (k % ncards) for k in range(4)]
    sc = parallel.dryrun(4)
    say('h', 'dryrun on %s: the planted read hits' % sc.mesh)

    mesh = parallel.make_mesh(2, 2, cards)
    for sieve in ('off', 'auto'):
        on = 'on' if sieve == 'auto' else 'off'
        engine.config(device='cuda', sieve=sieve, mesh=mesh, **SCAN)
        zero_launches(tps)
        ret, dt, scanner = countseqs_with_scanner(engine, path, seqs)
        n = tps.cand_counts.launches
        check(int(scanner.launches.sum()) == n, 'countseqs on %s: the '
              'entries count %d K1 launches, the wrapper %d'
              % (mesh, scanner.launches.sum(), n))
        s1 = tps.score_candidates.launches
        check(s1 > 0, 'countseqs sieve=%s on %s never launched S1'
              % (sieve, mesh))
        if sieve == 'off':
            check((scanner.launches > 0).all(), 'countseqs sieve=off on %s: '
                  'an entry never launched K1 (%s)'
                  % (mesh, scanner.launches.tolist()))
            gathered = scanner
        else:
            check(n == 0, 'the dense mesh scan launched K1 %d times' % n)
        by_path['countseqs mesh=2x2 sieve=%s' % on] = n
        S1_BY_PATH['countseqs mesh=2x2 sieve=%s' % on] = s1
        want = results[sieve]
        check(ret['stats'] == want['stats'], 'countseqs sieve=%s on %s: '
              'stats differ from the single-device scan' % (sieve, mesh))
        for t, (a, b) in enumerate(zip(ret['basecounts'],
                                       want['basecounts'])):
            check(np.array_equal(a, b), 'countseqs sieve=%s on %s: '
                  'basecounts[%d] differ from the single-device scan'
                  % (sieve, mesh, t))
        say('h', 'countseqs sieve=%s on %s: %d reads in %.3fs = %.1f reads/s, '
            'peak device memory %.2f GB, K1 launches per entry %s, S1 '
            'launches %d; basecounts and stats equal (c) bit for bit' % (
                sieve, mesh, ret['stats']['records_parsed'], dt,
                ret['stats']['records_parsed'] / dt,
                torch.cuda.max_memory_allocated() / 1e9,
                scanner.launches.tolist(), s1))

    # K1 on the bank-shard states that scan used, at its slice shapes: the
    # two 2,048-row slices of the first step, each on its entries' card, a
    # 576-row one (the last batch's slices), and the reverse complement of
    # the first slice (the corpus is planted from plus strands, and the
    # second shard holds the minus strands)
    batch = next(iter(reader.batches([path], ord(SCAN['Amin']),
                                     SCAN['minreadlength'],
                                     reader.ReaderStats(), batchsize=MAIN_B,
                                     nthreads=8)))
    sbank = gathered.context(batch.codes.shape[1])
    rc = revcomp_codes(batch.codes[:2048], batch.rl[:2048])
    slices = [(mesh.devices[i], 'rows %d-%d' % (i * 2048, i * 2048 + 2047),
               batch.codes[i * 2048:(i + 1) * 2048],
               batch.rl[i * 2048:(i + 1) * 2048]) for i in range(2)]
    slices += [(mesh.devices[0], 'rows 0-575', batch.codes[:576],
                batch.rl[:576]),
               (mesh.devices[0], 'rows 0-2047 reverse-complemented', rc,
                batch.rl[:2048])]
    entries = [(what, j, torch.from_numpy(np.ascontiguousarray(c)).to(dev),
                torch.from_numpy(r.astype(np.int32)).to(dev))
               for row, what, c, r in slices for j, dev in enumerate(row)]
    for what, j, B_, n_, k_, p_ in shard_screen_gate(
            tps, sbank, entries, [(SCAN['maxerrors'], SCAN['minoverlap'])]):
        say('h', 'K1 == cand_counts_ref exactly on bank shard %d of %d of the '
            'scan, corpus %s (B=%d, G=%d, Qp=%d, nch=%d, %d candidates); '
            'kernel %.3f ms, plain %.3f ms' % (
                j, sbank.n_bank, what, B_, sbank.G, sbank.Qp, sbank.nch, n_,
                k_, p_))
    del batch, rc, slices, entries, gathered

    mesh = parallel.make_mesh(1, 2, cards[:2])
    engine.config(device='cuda', sieve='off', mesh=mesh, **SCAN)
    zero_launches(tps)
    made = []
    got, dt, t_match, t_emit = timed_findseqs(engine, path, seqs, made)
    n = tps.cand_counts.launches
    check(int(made[0].launches.sum()) == n and (made[0].launches > 0).all(),
          'findseqs on %s: K1 launches per entry %s, by the wrapper %d'
          % (mesh, made[0].launches.tolist(), n))
    check(tps.hit_triplets.launches > 0, 'findseqs on %s never launched H1'
          % mesh)
    by_path['findseqs mesh=1x2 sieve=off'] = n
    H1_BY_PATH['findseqs mesh=1x2 sieve=off'] = tps.hit_triplets.launches
    check(got == hit_off, 'findseqs on %s: the hit stream (hits, hitseqs, '
          'stats) differs from the single-device one of (g)' % mesh)
    say('h', 'findseqs sieve=off on %s: %d reads in %.3fs = %.1f reads/s, '
        '%d hits; matcher %.3fs, _emit %.3fs; peak device memory %.2f GB, '
        'K1 launches per entry %s, H1 launches %d; the hit stream equals (g) '
        'tuple for tuple' % (
            mesh, got['stats']['records_parsed'], dt,
            got['stats']['records_parsed'] / dt, len(got['hits']), t_match,
            t_emit, torch.cuda.max_memory_allocated() / 1e9,
            made[0].launches.tolist(), tps.hit_triplets.launches))
    engine.config(mesh='')
    del got, made

    # batch through the CLI, merged and per sample
    t0 = time.time()
    parts = split_corpus(path, N_READS // 2)
    say('setup', 'corpus split into %s in %.1fs' % (
        ' + '.join(os.path.basename(p) for p in parts), time.time() - t0))
    cli = ['-q', '-t', 'testsuites']
    scanj = os.path.join(WORK, 'corpus.scan.json')
    batchj = os.path.join(WORK, 'corpus.batch.json')
    t0 = time.time()
    cli_main(cli + ['scan', '-f', '-l', 'MTBC', path, scanj])
    t_scan = time.time() - t0
    t0 = time.time()
    run([sys.executable, '-m', 'kvarq_tpu_torch.cli'] + cli
        + ['batch', '-f', '-l', 'MTBC', *parts, batchj])
    t_batch = time.time() - t0
    ref, out = json.load(open(scanj)), json.load(open(batchj))
    for key in ('coverages', 'analyses', 'stats'):
        check(out[key] == ref[key], 'batch of the two parts: %s differ from '
              'scan of the whole corpus' % key)
    say('h', 'batch of the 2 parts (%.1fs, process included) equals scan of '
        'the corpus (%.1fs, in this process): coverages, analyses, stats (%d '
        'records)'
        % (t_batch, t_scan, out['stats']['records_parsed']))
    psdir = os.path.join(WORK, 'per_sample')
    for name, (extra, _) in GOLDEN.items():
        cli_main(cli + ['batch', '-f', '--per-sample', '-l', 'MTBC', *extra,
                        os.path.join('tests', 'fastqs', name), psdir])
        ref = json.load(open(os.path.join(WORK, '%s.auto.json' % name)))
        out = json.load(open(os.path.join(
            psdir, name[:-len('.fastq')] + '.json')))
        for key in ('coverages', 'analyses', 'stats'):
            check(out[key] == ref[key], 'batch --per-sample %s: %s differ '
                  'from its scan' % (name, key))
    check(os.path.exists(os.path.join(psdir, 'summary.csv')),
          'batch --per-sample wrote no summary.csv')
    say('h', 'batch --per-sample on %s equals their scan results of (e): '
        'coverages, analyses, stats' % ' and '.join(GOLDEN))

    # scan_sharded: two processes against one
    stats = reader.ReaderStats()
    zero_launches(tps)
    t0 = time.time()
    one = sharded_arrays(*multihost.scan_sharded(
        parts, seqs, mesh=parallel.make_mesh(2, 2, cards), stats=stats,
        **SCAN), stats)
    t_one = time.time() - t0
    by_path['scan_sharded mesh=2x2 1 process'] = tps.cand_counts.launches
    S1_BY_PATH['scan_sharded mesh=2x2 1 process'] = \
        tps.score_candidates.launches
    check(tps.score_candidates.launches > 0, 'scan_sharded never launched S1')
    single = np.concatenate([c.ravel() for c in results['auto']['basecounts']])
    st = results['auto']['stats']
    check(np.array_equal(one['bc'], single)
          and one['sh'].tolist() == list(st['nseqhits'])
          and one['sbh'].tolist() == list(st['nseqbasehits'])
          and int(one['counts'][0]) == st['records_parsed']
          and int(one['counts'][1]) == st['parsed'],
          'scan_sharded in one process differs from the single-device scan')
    two, t_two = two_processes(parts, seqs)
    by_path['scan_sharded 2 processes'] = int(sum(r['launches'] for r in two))
    S1_BY_PATH['scan_sharded 2 processes'] = int(sum(r['score_launches']
                                                     for r in two))
    check(all(r['score_launches'] > 0 for r in two),
          'a scan_sharded process never launched S1')
    for i, r in enumerate(two):
        check(int(r['world']) == 2, 'process %d ran alone' % i)
        for key, value in one.items():
            check(np.array_equal(r[key], value), 'scan_sharded process %d: '
                  '%s differs from one process' % (i, key))
    say('h', 'scan_sharded in 2 processes (Gloo over localhost, %.1fs, start '
        'included) equals one process on a 2x2 mesh (%.1fs) and (c) bit for '
        'bit: basecounts, seqhits, seqbasehits, reader stats' % (t_two, t_one))


GUI_MODULES = ['kvarq_tpu_torch.gui.' + m for m in (
    'util', 'settings', 'tkplot', 'explorer', 'simple', 'main')]
GUI_TICK = 0.01     # seconds between two pumps of the GUI's timer queue


def gui_scan(faketk, engine, tps, fastq, suites, registry, stop=False):
    '''
    the port's scan wizard (``SimpleGUI``) over ``fastq`` with ``suites``
    ticked and the default settings, its timer queue pumped every
    ``GUI_TICK`` s until the worker is done; with ``stop``, "stop" is
    clicked at the first poll that shows this scan's progress.  K1's count
    is set to 0 just before "start".

    :returns: (the window, its analyser, wall s from "start" to the
        worker's end, K1 launches, the progress "stop" was clicked at)
    '''
    from kvarq_tpu_torch.config import default_config
    from kvarq_tpu_torch.gui.settings import Settings
    from kvarq_tpu_torch.gui.simple import SimpleGUI
    faketk.filedialog.askopenfilename = lambda *a, **kw: (fastq,)
    gui = SimpleGUI(Settings(dict(default_config)), testsuites={},
                    testsuite_paths=registry)
    check(gui.fastqs == [fastq], 'the GUI picked %r' % (gui.fastqs,))
    for button in gui.selector.buttons:
        if button.cget('text') in suites:
            button.invoke()
    errors = len([c for c in faketk.messagebox.calls if c[0] == 'showerror'])
    zero_launches(tps)
    t0 = time.time()
    gui.start.invoke()
    check(gui.running, 'the GUI did not start the scan of %s' % fastq)
    stopped_at = None
    while gui.worker is not None and time.time() - t0 < 300:
        faketk.pump(rounds=1)
        if stop and gui.running and engine._running \
                and engine.stats()['progress'] > 0:
            # "stop", and at once the poll that stops the engine: the
            # reader runs ahead of the scan by up to three batches
            stopped_at = engine.stats()['progress']
            gui.start.invoke()
            faketk.pump(rounds=1)
        time.sleep(GUI_TICK / 10 if stop else GUI_TICK)
    wall = time.time() - t0
    launches = tps.cand_counts.launches
    check(gui.worker is None, 'the GUI scan of %s did not end in 300 s'
          % fastq)
    shown = [c for c in faketk.messagebox.calls if c[0] == 'showerror']
    check(len(shown) == errors, 'the GUI scan of %s showed an error: %r'
          % (fastq, shown[errors:]))
    check(fastq in gui.analysers, 'the GUI recorded no result of %s' % fastq)
    return gui, gui.analysers[fastq], wall, launches, stopped_at


def gui_save(faketk, gui, path):
    ''' the GUI's "save" into ``path``: the saved json '''
    with open(path, 'w') as fd:
        faketk.filedialog.asksaveasfile = lambda *a, **kw: fd
        gui.save_cb()
    with open(path) as f:
        return json.load(f)


def gui_phase(engine, tps, path, seqs, hit_off, by_path, card):
    '''
    phase (i): the port's GUI on the card, headless through tests/faketk.py
    (its ``GUI_MODULES`` set to the port's modules), the engine at its
    defaults (the device, sieve on) and the scan wizard's default settings,
    every MTBC suite ticked:

    - the corpus: wall time, reads/s and K1 launches of the scan; its
      templates, hit list, hit sequences and reader stats against
      ``hit_off``, phase (g)'s findseqs of the corpus (gated against the
      numpy oracle and the coverage path); the saved json's coverages,
      analyses and stats against ``Analyser().scan`` of the corpus in this
      process (the same code outside the GUI); the saved json opened in
      ``JsonExplorer`` and ``DirectoryExplorer`` with no error dialog;
    - the same scan stopped at its first poll that shows progress: it ends
      mid-file with results for every suite;
    - the golden fixture N0116_1_hits_1k.fastq: the saved json against
      phase (e)'s ``--backend cpu`` run, with the golden calls.
    '''
    sys.path.insert(0, os.path.join(HERE, 'tests'))
    import faketk
    from kvarq_tpu_torch.analyse import Analyser
    from kvarq_tpu_torch.fastq import Fastq
    from kvarq_tpu_torch.testsuites import discover_testsuites

    registry = discover_testsuites([os.path.join(HERE, 'testsuites')])
    suites = sorted(n for n in registry if n.startswith('MTBC/'))
    gdir = os.path.join(WORK, 'gui')
    os.makedirs(gdir, exist_ok=True)
    for f in os.listdir(gdir):
        os.remove(os.path.join(gdir, f))
    engine.config(device='cuda', sieve='auto', mesh='', batchsize=16384)
    faketk.GUI_MODULES = GUI_MODULES
    with faketk.installed():
        try:
            from kvarq_tpu_torch.gui.explorer import (DirectoryExplorer,
                                                      JsonExplorer)
            gui, an, wall, n, _ = gui_scan(faketk, engine, tps, path, suites,
                                           registry)
            check(n > 0, 'the GUI scan never launched K1')
            check(tps.hit_triplets.launches > 0, 'the GUI scan never '
                  'launched H1')
            by_path['gui findseqs'] = n
            H1_BY_PATH['gui findseqs'] = tps.hit_triplets.launches
            nrec = an.stats['records_parsed']
            check(nrec == N_READS, 'the GUI scan parsed %d of %d records'
                  % (nrec, N_READS))
            tmpl = [c.plus_seq.bases for c in an.coverages.values()]
            tmpl += [c.minus_seq.bases for c in an.coverages.values()]
            check(tmpl == seqs, 'the GUI scanned other templates than (g)')
            for key in ('hits', 'hitseqs', 'stats'):
                check(getattr(an, key) == hit_off[key], 'the GUI scan of the '
                      'corpus: %s differ from (g)\'s findseqs' % key)
            jpath = os.path.join(gdir, 'corpus.json')
            data = gui_save(faketk, gui, jpath)
            ref = Analyser()
            ref.scan(Fastq(path), gui.selected_testsuites)
            ref.update_testsuites()
            want = json.loads(json.dumps(ref.encode()))
            for key in ('coverages', 'analyses', 'stats'):
                check(data[key] == want[key], 'the GUI scan of the corpus: %s '
                      'differ from Analyser().scan' % key)
            check(sorted(data['analyses']) == suites, 'the GUI saved analyses '
                  'of %s' % sorted(data['analyses']))
            say('i', 'GUI scan of the corpus (every MTBC suite, default '
                'settings, sieve on): %d reads in %.3fs from "start" to the '
                'worker\'s end (testsuite load included) = %.1f reads/s, %d '
                'hits, K1 launches %d; its hit list, hit sequences and stats '
                'equal (g)\'s findseqs, the saved coverages, analyses and '
                'stats equal Analyser().scan of the corpus; %s' % (
                    nrec, wall, nrec / wall, len(an.hits), n, card))
            explorer = JsonExplorer(jpath, testsuites={},
                                    testsuite_paths=registry)
            faketk.pump(rounds=5)
            check(all(any(item.startswith(s + ': ') for item in
                          explorer.alist.items) for s in suites),
                  'JsonExplorer lists %r' % explorer.alist.items)
            dx = DirectoryExplorer(gdir, testsuites={},
                                   testsuite_paths=registry)
            dx.jlist.selection_set(0)
            dx.open_json()
            shown = [c for c in faketk.messagebox.calls if c[0] == 'showerror']
            check(not shown, 'the explorers showed %r' % shown)
            say('i', 'the saved json opens in JsonExplorer (%d rows) and '
                'DirectoryExplorer (%s) with no error dialog' % (
                    len(explorer.alist.items), ', '.join(dx.jlist.items)))

            gui, an, wall, n, at = gui_scan(faketk, engine, tps, path,
                                            suites, registry, stop=True)
            by_path['gui findseqs stopped'] = n
            H1_BY_PATH['gui findseqs stopped'] = tps.hit_triplets.launches
            nrec = an.stats['records_parsed']
            check(at is not None and nrec < N_READS, 'the stopped GUI scan '
                  'parsed %d of %d records' % (nrec, N_READS))
            check(sorted(an.results) == suites, 'the stopped GUI scan has '
                  'results of %s' % sorted(an.results))
            gui_save(faketk, gui, os.path.join(gdir, 'stopped.json'))
            say('i', 'GUI scan stopped at the first poll that showed progress '
                '(%.3f): %d of %d records parsed in %.3fs, %d hits, results '
                'for every suite, K1 launches %d' % (
                    at, nrec, N_READS, wall, len(an.hits), n))

            name = 'N0116_1_hits_1k.fastq'
            fq = os.path.join(HERE, 'tests', 'fastqs', name)
            gui, an, wall, n, _ = gui_scan(faketk, engine, tps, fq, suites,
                                           registry)
            by_path['gui findseqs fixture'] = n
            H1_BY_PATH['gui findseqs fixture'] = tps.hit_triplets.launches
            data = gui_save(faketk, gui, os.path.join(gdir, name + '.json'))
            ref = json.load(open(os.path.join(WORK, name + '.ref.json')))
            for key in ('coverages', 'analyses', 'stats'):
                check(data[key] == ref[key], 'the GUI scan of %s: %s differ '
                      'from the hit path on the CPU' % (name, key))
            text = json.dumps(data['analyses'])
            for call in GOLDEN[name][1]:
                check(call in text, 'the GUI scan of %s: missing %r'
                      % (name, call))
            say('i', 'GUI scan of %s: coverages, analyses and stats equal the '
                'hit path on the CPU of (e), golden calls present; %.3fs, K1 '
                'launches %d' % (name, wall, n))
        finally:
            # the card's host may have no tkinter to re-import them against
            faketk.GUI_MODULES = []


def entry_phase(tps, by_path, card):
    '''
    phase (j): ``graft_entry.entry()`` on the card against
    ``entry(device='cpu')``, ``dryrun_multichip(4)``, and the tools
    ``device_bench`` and ``bench_scaling`` as processes
    '''
    import torch
    from kvarq_tpu_torch import graft_entry

    fn, (codes, rl) = graft_entry.entry()
    zero_launches(tps)
    got = [t.cpu() for t in fn(codes, rl)]
    n = tps.cand_counts.launches
    check(n > 0, 'entry() never launched K1')
    check(tps.score_candidates.launches > 0, 'entry() never launched S1')
    by_path['entry'] = n
    S1_BY_PATH['entry'] = tps.score_candidates.launches
    cfn, (ccodes, crl) = graft_entry.entry('cpu')
    check(torch.equal(codes.cpu(), ccodes) and torch.equal(rl.cpu(), crl),
          'entry(): the example reads differ between the card and the CPU')
    want = cfn(ccodes, crl)
    for what, a, b in zip(('basecount', 'seqhits', 'seqbasehits'), got, want):
        check(torch.equal(a, b), 'entry(): %s differs from the CPU' % what)
    ms = cuda_time_ms(lambda: fn(codes, rl))
    say('j', 'graft_entry.entry(): K1 launches %d; basecount, seqhits and '
        'seqbasehits equal entry(device="cpu") exactly (B=%d, G=%d, %d hits); '
        'the step %.3f ms' % (n, len(codes), got[0].shape[1],
                             int(got[1][:-1].sum()), ms))
    zero_launches(tps)
    sc = graft_entry.dryrun_multichip(4)
    by_path['dryrun_multichip(4)'] = tps.cand_counts.launches
    S1_BY_PATH['dryrun_multichip(4)'] = tps.score_candidates.launches
    check(tps.score_candidates.launches > 0,
          'dryrun_multichip(4) never launched S1')
    say('j', 'dryrun_multichip(4) on %s: the planted read hits, K1 launches '
        'per entry %s' % (sc.mesh, sc.launches.tolist()))

    out = run([sys.executable, '-m', 'kvarq_tpu_torch.tools.device_bench'],
              timeout=600)
    bench = json.loads(out.strip().splitlines()[-1])
    by_path['device_bench'] = bench['cand_launches']
    S1_BY_PATH['device_bench'] = bench['score_launches']
    check(bench['cand_launches'] > 0, 'device_bench never launched K1')
    check(bench['score_launches'] > 0, 'device_bench never launched S1')
    say('j', 'device_bench: %d reads in batches of %d on %s in %.3fs: %.1f '
        'reads/s, %.2f TOP/s, %d hit weight, up to %d candidates per batch '
        '(gather_k %d), K1 launches %d, S1 launches %d; %s' % (
            bench['reads'], bench['batch'], bench['device'], bench['seconds'],
            bench['reads_per_s'], bench['tops'], bench['hit_weight'],
            bench['max_candidates'], bench['gather_k'],
            bench['cand_launches'], bench['score_launches'], card))
    out = run([sys.executable, '-m', 'kvarq_tpu_torch.tools.bench_scaling',
               '--max', '4'], timeout=600)
    scaling = json.loads(out.strip().splitlines()[-1])
    check(sorted(scaling['per_device_reads_per_s']) == ['1', '2', '4'],
          'bench_scaling measured %r' % scaling)
    say('j', 'bench_scaling --max 4 (mesh entries on %d card(s), repeated): '
        'reads/s per entry count %s, efficiency %s; %s' % (
            torch.cuda.device_count(),
            ', '.join('%s: %.1f' % kv for kv in
                      scaling['per_device_reads_per_s'].items()),
            scaling['efficiency'], card))


def cli_phase(hit_off, path, by_path, card):
    '''
    phase (e): CLI golden runs on the card against the port's own run of
    the hit path on the CPU (which the tests hold equal to kvarq_tpu's
    numpy hit path): the coverage path, then -H -x, then ``--backend
    numpy`` and ``auto``, then one ``--profile`` trace; ``auto`` on the
    corpus against ``hit_off``, (g)'s findseqs.  Cold start: on
    COLD_FIXTURE each timed run is a process of its own (wall seconds,
    start included), on the card, on the CPU, with numpy and auto, the
    card's coverage path timed in parts; every other run is ``cli.main``
    in this process.
    '''
    q = ['-q', '-t', 'testsuites', 'scan', '-f', '-l', 'MTBC']
    for name, (extra, calls) in GOLDEN.items():
        fq = os.path.join('tests', 'fastqs', name)
        cold = name == COLD_FIXTURE
        refj = os.path.join(WORK, name + '.ref.json')
        refx = os.path.join(WORK, name + '.ref.hits.fastq')
        t = {k: [] for k in ('cov card', 'cov cpu', 'cov numpy', 'cov auto',
                             'hits card', 'hits cpu')}
        cli_scan(q + ['--backend', 'cpu', '-H', '-x', refx, *extra, fq, refj],
                 cold, seconds=t['hits cpu'])
        if cold:
            cli_scan(q + ['--backend', 'cpu', *extra, fq,
                          os.path.join(WORK, name + '.cpu.json')], cold,
                     seconds=t['cov cpu'])
        ref = json.load(open(refj))
        with open(refx, 'rb') as f:
            ref_records = f.read()
        for sieve in ('off', 'auto'):
            outj = os.path.join(WORK, '%s.%s.json' % (name, sieve))
            if cold and sieve == 'auto':
                # the card's coverage path in a cold process, in parts
                out = run([sys.executable, '-c', COLD_PARTS] + q
                          + [*extra, fq, outj], seconds=t['cov card'])
                parts = json.loads(out.strip().splitlines()[-1])
            else:
                cli_main(q + [*extra, fq, outj], sieve)
            text = cli_main(['-q', '-t', 'testsuites', 'illustrate', '-r',
                             outj])
            for call in calls:
                check(call in text, '%s sieve=%s: missing %r' % (name, sieve,
                                                                 call))
            out = json.load(open(outj))
            for key in ('coverages', 'analyses', 'stats'):
                check(out[key] == ref[key], '%s sieve=%s: %s differ from the '
                      'hit path on the CPU' % (name, sieve, key))
        say('e', '%s: golden calls present, coverages/analyses/stats equal '
            'the hit path on the CPU (sieve off and on)' % name)
        for sieve in ('off', 'auto'):
            outj = os.path.join(WORK, '%s.%s.hits.json' % (name, sieve))
            outx = os.path.join(WORK, '%s.%s.hits.fastq' % (name, sieve))
            cli_scan(q + ['-H', '-x', outx, *extra, fq, outj],
                     cold and sieve == 'auto', sieve, seconds=t['hits card'])
            out = json.load(open(outj))
            for key in ('coverages', 'analyses', 'stats', 'hits', 'hitseqs'):
                check(out[key] == ref[key], '%s -H sieve=%s: %s differ from '
                      'the hit path on the CPU' % (name, sieve, key))
            with open(outx, 'rb') as f:
                check(f.read() == ref_records, '%s -x sieve=%s: extracted '
                      'records differ from the hit path on the CPU'
                      % (name, sieve))
        say('e', '%s -H -x: json (coverages, analyses, stats, %d hits) and '
            'the %d bytes of extracted records equal the hit path on the '
            'CPU (sieve off and on)' % (name, len(ref['hits']),
                                        len(ref_records)))
        # the numpy backend, and on COLD_FIXTURE auto in a fresh process
        # (with -d: its log names the path), against the card's json
        card_json = json.load(open(os.path.join(WORK, '%s.auto.json' % name)))
        for backend in ('numpy', 'auto') if cold else ('numpy',):
            outj = os.path.join(WORK, '%s.backend-%s.json' % (name, backend))
            args = q + ['--backend', backend, *extra, fq, outj]
            if backend == 'auto':
                _, log = run([sys.executable, '-m', 'kvarq_tpu_torch.cli', '-d']
                             + args[1:], seconds=t['cov auto'], stderr=True)
                check(SMALL_LOG in log, '%s --backend auto: no "%s" in its '
                      'log' % (name, SMALL_LOG))
            else:
                cli_scan(args, cold, seconds=t['cov numpy'])
            out = json.load(open(outj))
            for key in ('coverages', 'analyses', 'stats'):
                check(out[key] == card_json[key], '%s --backend %s: %s differ '
                      'from the card\'s' % (name, backend, key))
        say('e', '%s: --backend numpy%s: the card\'s coverages, analyses '
            'and stats' % (name, ' and --backend auto (which took the numpy '
                           'path: its -d log says "%s")' % SMALL_LOG
                           if cold else ''))
        if not cold:
            continue
        say('e', 'cold start, %s (%d records), one process each, start '
            'included: coverage path card %.3fs, cpu %.3fs, numpy %.3fs, auto '
            '%.3fs; hit path (-H -x) card %.3fs, cpu %.3fs; %s' % (
                name, ref['stats']['records_parsed'], t['cov card'][0],
                t['cov cpu'][0], t['cov numpy'][0], t['cov auto'][0],
                t['hits card'][0], t['hits cpu'][0], card))
        say('e', 'the card\'s coverage-path process in parts, %s: %s; process '
            'start and the rest %.3fs; %.3fs in all' % (
                name, ', '.join('%s %.3fs' % kv for kv in parts.items()),
                t['cov card'][0] - sum(parts.values()), t['cov card'][0]))

    # auto on the corpus (far over the small-scan limit) runs on the card:
    # the hit path, K1 launched as often as (g)'s findseqs sieve on
    outj = os.path.join(WORK, 'corpus.backend-auto.hits.json')
    wall = []
    n, log = counted_cli(['-d', '-t', 'testsuites', 'scan', '-f', '-l', 'MTBC',
                          '--backend', 'auto', '-H', path, outj], stderr=True,
                         seconds=wall)
    check(AUTO_DEVICE_LOG in log and SMALL_LOG not in log, '--backend auto '
          'on the corpus: its log does not say that it scanned on the card')
    check(n == by_path['findseqs sieve=on'], '--backend auto -H on the corpus '
          'launched K1 %d times, (g) %d' % (n, by_path['findseqs sieve=on']))
    by_path['cli scan --backend auto -H corpus'] = n
    out = json.load(open(outj))
    check(out['hits'] == [list(h) for h in hit_off['hits']]
          and out['hitseqs'] == hit_off['hitseqs']
          and out['stats'] == json.loads(json.dumps(hit_off['stats'])),
          '--backend auto -H on the '
          'corpus: hits or stats differ from (g)')
    say('e', '--backend auto -H on the corpus (%d reads, %.0f MB): "%s", K1 '
        'launches %d as (g) sieve on; its %d hits and stats equal (g); %.3fs, '
        'process included' % (N_READS, os.path.getsize(path) / 1e6,
                              AUTO_DEVICE_LOG, n, len(out['hits']), wall[0]))
    del out

    fq = os.path.join('tests', 'fastqs', 'N0116_1_hits_1k.fastq')
    outj = os.path.join(WORK, 'profile.json')
    tdir = os.path.join(WORK, 'profile_trace')
    # a process of its own: torch.profiler in the CLI's worker thread, in
    # a process that has traced the card before, is not relied on
    cli_scan(q + ['-H', '--profile', tdir, fq, outj], True, 'off')
    from kvarq_tpu_torch.profiling import TRACE_FILE
    phases = json.load(open(outj))['info'].get('phases', {})
    check(set(phases) == {'scan', 'analyse', 'total'},
          '--profile wrote phases %r' % sorted(phases))
    with open(os.path.join(tdir, TRACE_FILE)) as f:
        names = [str(ev.get('name')) for ev in json.load(f)['traceEvents']]
    nk1 = sum('cand_screen_kernel' in n for n in names)
    check(nk1 > 0, '--profile trace holds no cand_screen_kernel event')
    say('e', '--profile (-H, sieve off): info.phases %s; trace of %d events, '
        '%d of them cand_screen_kernel' % (
            ' '.join('%s=%.3fs' % kv for kv in sorted(phases.items())),
            len(names), nk1))


def hitdiff_phase(engine, tps, by_path, card):
    """
    phase (k): the port's ``tools/hitdiff`` full sweep (fixture templates
    of 3-4 bases, the golden 5k MTBC extract, six random corpora with N
    reads in three; maxerrors 0-3, minoverlap 3-25) on the card, then with
    ``--backend numpy``: every ``findseqs`` hit stream must equal the C
    reference's (``kvarq_tpu_torch/csrc/ref_bench.c``, built with ``cc``:
    no C compiler fails the phase).  After each case on the card,
    ``countseqs`` with the sieve off (K1, compaction, every candidate scored)
    must equal the numpy backend's.  Records the ``(Lpad, nch, maxerrors,
    minoverlap)`` K1 is given.
    """
    import collections
    from kvarq_tpu_torch.tools import hitdiff

    binpath = hitdiff.build_ref_bench()
    check(binpath is not None, 'no C compiler (cc, gcc, clang) to build '
          'ref_bench.c')
    wdir = os.path.join(WORK, 'hitdiff')
    os.makedirs(wdir, exist_ok=True)
    screen = tps.cand_counts
    shapes = collections.Counter()
    cov = dict(launches=0, cases=0, scored=0)

    def recorded(codes, rl, state, maxerrors, minoverlap, nch):
        if codes.device.type == 'cuda':
            shapes[(codes.shape[1], nch, maxerrors, minoverlap)] += 1
        return screen(codes, rl, state, maxerrors, minoverlap, nch)

    def countseqs_check(case):
        fastq, seqs = case[:2]
        sieve = engine._extra_config['sieve']
        before = tps.cand_counts.launches
        scored = tps.score_candidates.launches
        engine.config(sieve='off', backend='device', device='cuda')
        got = engine.countseqs(fastq, seqs)
        cov['launches'] += tps.cand_counts.launches - before
        cov['scored'] += tps.score_candidates.launches - scored
        engine.config(backend='numpy')
        want = engine.countseqs(fastq, seqs)
        engine.config(sieve=sieve, backend='device')
        check(got['stats'] == want['stats'] and all(
            np.array_equal(a, b) for a, b in zip(got['basecounts'],
                                                 want['basecounts'])),
              'countseqs sieve=off on the card differs from the numpy '
              'backend (%s e=%d o=%d)' % (os.path.basename(fastq), case[3],
                                          case[4]))
        cov['cases'] += 1

    # the wrapper counts its launches on the name it is called by (its
    # module's ``cand_counts``): the recorder holds the count meanwhile
    results = {}
    h1 = {}
    recorded.launches = screen.launches
    tps.cand_counts = recorded
    progress = os.path.join(wdir, 'progress.txt')
    try:
        for backend in ('device', 'numpy'):
            n0, h0 = recorded.launches, tps.hit_triplets.launches
            t0 = time.time()
            total = ncases = 0
            for case in hitdiff.cases(wdir):
                # the case at work, for a run that the watchdog ends
                with open(progress, 'w') as f:
                    f.write('%s %s e=%d o=%d\n' % (
                        backend, os.path.basename(case[0]), case[3], case[4]))
                try:
                    total += hitdiff.run_case(binpath, *case, wdir,
                                              device='cuda', backend=backend)
                except AssertionError as e:
                    raise SmokeFailure('hitdiff --device cuda%s: %s' % (
                        ' --backend numpy' if backend == 'numpy' else '', e))
                ncases += 1
                if backend == 'device':
                    countseqs_check(case)
            results[backend] = (total, ncases, time.time() - t0,
                                recorded.launches - n0)
            h1[backend] = tps.hit_triplets.launches - h0
    finally:
        screen.launches = recorded.launches
        tps.cand_counts = screen
        engine.config(backend='device')
    total, ncases, dt, n = results['device']
    n -= cov['launches']
    check(n > 0, 'hitdiff on the card never launched K1')
    check(h1['device'] >= n and h1['numpy'] == 0, 'hitdiff: H1 launches %r, '
          'K1 %d on the card' % (h1, n))
    check(results['numpy'][:2] == (total, ncases) and results['numpy'][3] == 0,
          'hitdiff --backend numpy compared %r, the card %r'
          % (results['numpy'][:2], (total, ncases)))
    seen = set(shapes)
    check({k[1] for k in seen} == {4, 5}
          and {k[2] for k in seen} == {0, 1, 2, 3}
          and {k[3] for k in seen} == {3, 10, 20, 25},
          'K1 was not given every nch, maxerrors and minoverlap of the sweep: '
          '%s' % sorted(seen))
    by_path['hitdiff findseqs'] = n
    H1_BY_PATH['hitdiff findseqs'] = h1['device']
    by_path['hitdiff countseqs sieve=off'] = cov['launches']
    S1_BY_PATH['hitdiff countseqs sieve=off'] = cov['scored']
    check(cov['scored'] > 0, 'the hitdiff countseqs checks never launched S1')
    say('k', 'hitdiff --device cuda (full sweep): %d hits in %d cases equal '
        'ref_bench.c\'s tuple for tuple, %.1fs (the countseqs checks '
        'included); K1 launches %d and H1 launches %d on the hit path; '
        'countseqs sieve=off on the card equals the numpy backend in all %d '
        'cases (K1 launches %d, S1 launches %d)' % (
            total, ncases, dt, n, h1['device'], cov['cases'],
            cov['launches'], cov['scored']))
    say('k', 'K1 was given (Lpad, nch, maxerrors, minoverlap) x launches: %s'
        % ', '.join('(%d, %d, %d, %d) x %d' % (k + (v,))
                    for k, v in sorted(shapes.items())))
    say('k', 'hitdiff --backend numpy (full sweep): %d hits in %d cases equal '
        'ref_bench.c\'s, %.1fs; %s' % (results['numpy'][0],
                                       results['numpy'][1],
                                       results['numpy'][2], card))


def paired_phase(engine, tps, seqs, windows, path, by_path, card):
    """
    phase (l): the corpus and a second 2M-read mate (another seed) as a
    ``*_1.fastq``/``*_2.fastq`` pair, plain, single-member gz and BGZF
    (``tools/gz_bench``'s writers), each scanned by the CLI (``cli.main``
    in this process) on the card with paired detection on, sieve on and
    off: coverages, analyses and
    the exact stats must equal the plain pair's, which must equal
    ``Analyser.scan`` (``countseqs([f1, f2])``) in this process; the
    mate's first 8192 reads are gated against the numpy oracle.  Then the
    reader alone over file 1 of each variant (``gz_bench.drain``).
    """
    from kvarq_tpu_torch import bench
    from kvarq_tpu_torch.analyse import Analyser
    from kvarq_tpu_torch.fastq import Fastq
    from kvarq_tpu_torch.tools import gz_bench

    pdir = os.path.join(WORK, 'pair')
    t0 = time.time()
    mate = os.path.join(pdir, 'plain', 'corpus_2.fastq')
    first = os.path.join(pdir, 'plain', 'corpus_1.fastq')
    os.makedirs(os.path.dirname(mate), exist_ok=True)
    if not os.path.exists(mate):
        bench.generate_fastq(mate + '.tmp', windows, N_READS, READLEN,
                             seed=MATE_SEED)
        os.replace(mate + '.tmp', mate)
    if not os.path.exists(first):
        try:
            os.link(path, first)
        except OSError:
            shutil.copyfile(path, first)
    t_gen = time.time() - t0
    files = {'plain': first}
    t0 = time.time()
    jobs = []
    for variant, write in (('gz', gz_bench.write_gz),
                           ('bgzf', gz_bench.write_bgzf)):
        os.makedirs(os.path.join(pdir, variant), exist_ok=True)
        for src in (first, mate):
            dst = os.path.join(pdir, variant,
                               os.path.basename(src) + '.gz')
            if not os.path.exists(dst):
                jobs.append((write, src, dst))
        files[variant] = os.path.join(pdir, variant, 'corpus_1.fastq.gz')

    def compress(job):
        write, src, dst = job
        write(dst + '.tmp', src)
        os.replace(dst + '.tmp', dst)

    # zlib lets go of the interpreter lock: the four files in parallel
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        list(pool.map(compress, jobs))
    say('setup', 'mate corpus_2.fastq (seed %d) in %.1fs; gz and BGZF copies '
        'of both in %.1fs: %s' % (
            MATE_SEED, t_gen, time.time() - t0, ', '.join(
                '%s %.0f+%.0f MB' % (v, os.path.getsize(f) / 1e6,
                                     os.path.getsize(f.replace('_1.', '_2.'))
                                     / 1e6) for v, f in files.items())))

    # the mate's first 8192 reads against the numpy oracle, as (d) does for
    # the corpus
    mprefix = os.path.join(pdir, 'corpus_2_prefix_8192.fastq')
    with open(mate) as f, open(mprefix, 'w') as g:
        for _ in range(4 * 8192):
            g.write(f.readline())
    engine.config(device='cuda', sieve='auto', backend='device', **SCAN)
    oracle_gate(engine.countseqs(mprefix, seqs), mprefix, seqs, None)

    out, walls = {}, {}
    for variant, f1 in files.items():
        for sieve in ('auto', 'off'):
            outj = os.path.join(pdir, '%s.sieve-%s.json' % (variant, sieve))
            zero_launches(tps)
            t0 = time.time()
            cli_main(['-q', '-t', 'testsuites', 'scan', '-f', '-l', 'MTBC',
                      f1, outj], sieve)
            wall, n = time.time() - t0, tps.cand_counts.launches
            check((n > 0) == (sieve == 'off'), 'paired %s sieve=%s: K1 '
                  'launches %d' % (variant, sieve, n))
            if sieve == 'off':
                by_path['cli scan paired %s sieve=off' % variant] = n
            S1_BY_PATH['cli scan paired %s sieve=%s' % (
                variant, 'on' if sieve == 'auto' else 'off')] = \
                tps.score_candidates.launches
            check(tps.score_candidates.launches > 0, 'paired %s sieve=%s: no '
                  'S1 launch' % (variant, sieve))
            out[variant, sieve] = json.load(open(outj))
            walls[variant, sieve] = (wall, n)
    ref = out['plain', 'auto']
    check(ref['stats']['records_parsed'] == 2 * N_READS, 'the plain pair: '
          '%d records parsed' % ref['stats']['records_parsed'])
    an = Analyser()
    an.scan(Fastq(first, paired=True), bench.load_mtbc(), keep_hits=False)
    an.update_testsuites()
    want = json.loads(json.dumps(an.encode()))
    for key in ('coverages', 'analyses', 'stats'):
        check(ref[key] == want[key], 'the plain pair\'s CLI json: %s differ '
              'from Analyser.scan (countseqs of the pair) in this process'
              % key)
    exact = ('nseqhits', 'nseqbasehits', 'readlengths', 'records_parsed')
    for (variant, sieve), data in out.items():
        for key in ('coverages', 'analyses'):
            check(data[key] == ref[key], 'paired %s sieve=%s: %s differ from '
                  'the plain pair sieve on' % (variant, sieve, key))
        for key in exact:
            check(data['stats'][key] == ref['stats'][key], 'paired %s '
                  'sieve=%s: stats[%r] differ from the plain pair'
                  % (variant, sieve, key))
    say('l', 'the plain pair (2 x %d reads) equals Analyser.scan of the pair '
        '(countseqs([f1, f2])) in this process; the mate\'s first 8192 reads '
        'equal the numpy oracle; gz and BGZF, sieve on and off, give its '
        'coverages, analyses and stats (%s)' % (N_READS, ', '.join(exact)))
    for (variant, sieve), (wall, n) in walls.items():
        say('l', 'CLI scan (cli.main in this process: testsuite load, scan, '
            'analyses, json) of the %s pair, sieve %s: %.3fs = %.1f reads/s, '
            'K1 launches %d; %s' % (
                variant, 'on' if sieve == 'auto' else 'off', wall,
                2 * N_READS / wall, n, card))
    rates = {}
    for variant, f1 in files.items():
        nrec, _, parsed, dt = gz_bench.drain(f1, SCAN['nthreads'])
        check(nrec == N_READS, 'gz_bench.drain %s: %d records' % (variant,
                                                                   nrec))
        rates[variant] = nrec / dt
        say('l', 'reader alone (gz_bench.drain, %d threads) over file 1, %s: '
            '%d records, %.2f GB decompressed in %.3fs: %.0f reads/s, %.0f '
            'MB/s, %.0f%% of plain' % (
                SCAN['nthreads'], variant, nrec, parsed / 1e9, dt, nrec / dt,
                parsed / dt / 1e6, 100 * rates[variant] / rates['plain']))


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is False', file=sys.stderr)
        return 1
    from kvarq_tpu_torch import bench, device, engine
    from kvarq_tpu_torch.engine import native_cuda, reader
    from kvarq_tpu_torch.engine import pallas_scan as tps
    from kvarq_tpu_torch.engine import tensor_scan as tts

    t_start = time.time()
    stamps = []
    stamp(stamps, 'a')
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
    t0 = time.time()
    native_cuda.load_all(KERNEL_SOURCES)
    say('a', '%s built in %.2fs, at the same time (nvcc sm_90a: %s)' % (
        ' and '.join(KERNEL_SOURCES), time.time() - t0, ', '.join(
            '%s %.2fs' % (k, native_cuda.build_seconds[k])
            for k in KERNEL_SOURCES)))

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

    # (b) K1 and S1 against their plain versions on one real main-path
    # batch
    stamp(stamps, 'b')
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
    say('b', 'ptxas -v of cand_screen.cu: %s' % ptxas_summary(
        native_cuda.ptxas_report.get('cand_screen.cu', '')))
    k1 = k1_phase(tps, codes, rl, state, e, mo, bank, card)
    mm_ms = k1['matmul_ms']
    s1 = s1_phase(tps, native_cuda, codes, rl, state, e, mo, mm_ms, card)
    h1 = h1_phase(tps, codes, rl, state, e, mo, mm_ms, k1['candidates'],
                  card)

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
        idx5, n5 = tps.compact(got5 > 0)
        for form, args in (('dense', ()), ('gathered', (idx5, n5))):
            want5, k5 = tps.triplets_to_host(*tps.hit_triplets_ref(
                c5, r5, state5, e5, mo5, *args, cap=None))
            got5t, g5 = tps.triplets_to_host(*tps.hit_triplets(
                c5, r5, state5, e5, mo5, *args, cap=max(1, k5)))
            check(g5 == k5 > 0 and np.array_equal(
                got5t[np.lexsort(got5t.T[::-1])],
                want5[np.lexsort(want5.T[::-1])]),
                'H1 differs from hit_triplets_ref on the 5-channel bank '
                '(%s, e=%d: %d triplets against %d)' % (form, e5, g5, k5))
            say('b', 'H1 == hit_triplets_ref exactly on the 5-channel bank '
                '(%s, e=%d, mo=%d, %d triplets)' % (form, e5, mo5, k5))
    from kvarq_tpu_torch import parallel
    sbank5 = parallel.ShardBank(nbank, 128, 2, 10)
    check(sbank5.nch == 5, '5-channel shard bank expected')
    for _, j, B5, n5, k5, p5 in shard_screen_gate(
            tps, sbank5, [(None, j, c5[sl], r5[sl]) for j in range(2)
                          for sl in (slice(0, 2048), slice(2048, None))],
            ((0, 25), (3, 8))):
        say('b', 'K1 == cand_counts_ref exactly on shard %d of the 5-channel '
            'bank split in 2 (B=%d, G=%d, Qp=%d, e=0 and 3, %d candidates); '
            'kernel %.3f ms, plain %.3f ms' % (j, B5, sbank5.G, sbank5.Qp,
                                               n5, k5, p5))
    del codes, rl, c5, r5, state5, sbank5

    stamp(stamps, 'd')
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

    stamp(stamps, 'c')
    # (c) the main path over the corpus: unsieved (K1, compaction, S1 on
    # the candidates) and sieved (S1 on every read)
    results, peak = {}, {}
    for sieve in ('off', 'auto'):
        engine.config(device='cuda', sieve=sieve, **SCAN)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_launches(tps)
        t0 = time.time()
        ret = engine.countseqs(path, seqs)
        torch.cuda.synchronize()
        dt = time.time() - t0
        on = 'on' if sieve == 'auto' else 'off'
        S1_BY_PATH['countseqs sieve=%s' % on] = tps.score_candidates.launches
        check(tps.score_candidates.launches > 0, 'countseqs sieve=%s never '
              'launched S1' % on)
        peak[sieve] = torch.cuda.max_memory_allocated()
        if sieve == 'off':
            launches = tps.cand_counts.launches
            check(launches > 0, 'the unsieved scan never launched K1')
        else:
            check(tps.cand_counts.launches == 0, 'the sieved scan launched '
                  'K1')
        nrec = ret['stats']['records_parsed']
        check(nrec == N_READS, 'parsed %d of %d records' % (nrec, N_READS))
        results[sieve] = ret
        say('c', 'sieve=%s: %d reads in %.3fs = %.1f reads/s, %d template '
            'hits, peak device memory %.2f GB, steps of %d-read batches, '
            'S1 launches %d%s; %s' % (
                sieve, nrec, dt, nrec / dt, sum(ret['stats']['nseqhits']),
                peak[sieve] / 1e9, MAIN_B, tps.score_candidates.launches,
                ', K1 launches %d' % launches if sieve == 'off' else '',
                card))
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
            'in %d batches); scanner alone %.3fs (gather_k ends at %d)' % (
                sieve, '+sieve' if sieve == 'auto' else '', t_read,
                sum(len(r) for _, r in held), len(held), t_dev, sc.gather_k))
        if sieve == 'off':
            unsieved = held
        del held, sc
    no_sync_gate(tps, tts, reader, dev, seqs, unsieved, results['off'], card)
    del unsieved

    # where the time goes: one scan per mode under torch.profiler (its
    # wall time includes the profiler's own cost)
    for sieve in ('off', 'auto'):
        engine.config(device='cuda', sieve=sieve, **SCAN)
        wall, busy, k1t, s1t, _, top = traced_scan(engine.countseqs, path,
                                                   seqs)
        if busy == 0:
            say('trace', 'sieve=%s: wall %.3fs; kernel time not measured '
                '(the profiler saw no device activity)' % (sieve, wall))
            continue
        say('trace', 'sieve=%s: wall %.3fs, kernel time on the card %.3fs '
            '(%.1f%% busy), K1 %.3fs, S1 %.3fs (%.1f%% of the kernel time); '
            'longest: %s' % (
                sieve, wall, busy, 100 * busy / wall, k1t, s1t,
                100 * s1t / busy, '; '.join('%s %.1f ms' % kv for kv in top)))

    stamp(stamps, 'g')
    # (g) the hit path (findseqs) over the same corpus: every batch through
    # K1, sieve off and on
    by_path = {'countseqs sieve=off': launches}
    hit = {}
    for sieve in ('off', 'auto'):
        engine.config(device='cuda', sieve=sieve, **SCAN)
        zero_launches(tps)
        got, dt, t_match, t_emit = timed_findseqs(engine, path, seqs)
        n, nh = tps.cand_counts.launches, tps.hit_triplets.launches
        on = 'on' if sieve == 'auto' else 'off'
        check(n > 0, 'findseqs sieve=%s never launched K1' % on)
        check(nh >= n, 'findseqs sieve=%s: H1 launches %d, K1 %d (one each '
              'per batch, and a rerun after an overflow)' % (on, nh, n))
        by_path['findseqs sieve=%s' % on] = n
        H1_BY_PATH['findseqs sieve=%s' % on] = nh
        peak_hits = torch.cuda.max_memory_allocated()
        check(peak_hits < HIT_PEAK_LIMIT, 'findseqs sieve=%s: peak device '
              'memory %.2f GB, above %.2f GB' % (on, peak_hits / 1e9,
                                                 HIT_PEAK_LIMIT / 1e9))
        nrec = got['stats']['records_parsed']
        check(nrec == N_READS, 'parsed %d of %d records' % (nrec, N_READS))
        hit[sieve] = got
        say('g', 'findseqs sieve=%s: %d reads in %.3fs = %.1f reads/s, %d '
            'hits; matcher %.3fs, _emit %.3fs; this cell\'s peak device '
            'memory %.3f GB; K1 launches %d, H1 launches %d; %s' % (
                on, nrec, dt, nrec / dt, len(got['hits']), t_match,
                t_emit, peak_hits / 1e9, n, nh, card))
    check(hit['off'] == hit['auto'], 'findseqs sieve on/off hit streams '
          '(hits, hitseqs, stats) differ')
    check(len(hit['off']['hits']) > 0, 'no hits in corpus')
    hits_gate(hit['off'], results['off'], seqs, 'corpus')
    for sieve in ('off', 'auto'):
        engine.config(device='cuda', sieve=sieve, **SCAN)
        check(engine.findseqs(prefix, seqs) == found, 'findseqs sieve=%s '
              'differs from the numpy oracle on the first 8192 reads' % sieve)
    say('g', 'hit streams sieve on and off identical (%d hits); replayed, '
        'they equal the countseqs basecounts and stats of (c); on the first '
        '8192 reads both equal the numpy oracle tuple for tuple (%d hits)'
        % (len(hit['off']['hits']), len(found['hits'])))
    engine.config(device='cuda', sieve='off', **SCAN)
    wall, busy, k1t, _, h1t, top = traced_scan(engine.findseqs, path, seqs)
    say('trace', 'findseqs sieve=off: wall %.3fs, kernel time on the card '
        '%.3fs (%.1f%% busy), K1 %.3fs, H1 %.3fs; longest: %s' % (
            wall, busy, 100 * busy / max(wall, 1e-9), k1t, h1t,
            '; '.join('%s %.1f ms' % kv for kv in top)))
    hit_off = hit['off']        # (h) and (i) hold the mesh and GUI to it
    del hit

    # (g') hit-dense: half the reads planted, sieve off (compaction keeps
    # about half of each batch)
    t0 = time.time()
    dpath, dprefix = corpus(windows, DENSE_READS, DENSE_PLANT)
    say('setup', 'hit-dense corpus %s ready in %.1fs' % (
        os.path.basename(dpath), time.time() - t0))
    engine.config(device='cuda', sieve='off', **SCAN)
    zero_launches(tps)
    made = []
    got, dt, t_match, t_emit = timed_findseqs(engine, dpath, seqs, made)
    n, nh = tps.cand_counts.launches, tps.hit_triplets.launches
    check(n > 0 and nh >= n, 'hit-dense findseqs: K1 launches %d, H1 %d'
          % (n, nh))
    by_path['findseqs hit-dense sieve=off'] = n
    H1_BY_PATH['findseqs hit-dense sieve=off'] = nh
    peak_hits = torch.cuda.max_memory_allocated()
    check(peak_hits < HIT_PEAK_LIMIT, 'hit-dense findseqs: peak device '
          'memory %.2f GB, above %.2f GB' % (peak_hits / 1e9,
                                             HIT_PEAK_LIMIT / 1e9))
    nrec = got['stats']['records_parsed']
    check(nrec == DENSE_READS, 'parsed %d of %d hit-dense records'
          % (nrec, DENSE_READS))
    say("g'", 'findseqs hit-dense sieve=off: %d reads in %.3fs = %.1f '
        'reads/s, %d hits; matcher %.3fs, _emit %.3fs; this cell\'s peak '
        'device memory %.3f GB; K1 launches %d, H1 launches %d (reruns '
        'after an overflow included; the triplet capacity ends at %d); %s'
        % (nrec, dt, nrec / dt, len(got['hits']), t_match, t_emit,
           peak_hits / 1e9, n, nh, made[0].xla.cap, card))
    hits_gate(got, engine.countseqs(dpath, seqs), seqs, 'hit-dense corpus')
    want = numpy_oracle(engine, dprefix, seqs)
    check(engine.findseqs(dprefix, seqs) == want, 'hit-dense findseqs differs '
          'from the numpy oracle on the first 8192 reads')
    say("g'", 'replayed, the hit list equals the countseqs basecounts and '
        'stats; on the first 8192 reads it equals the numpy oracle tuple for '
        'tuple (%d hits)' % len(want['hits']))
    del got, want

    stamp(stamps, 'e')
    cli_phase(hit_off, path, by_path, card)

    # (h) the scale-out layer, bit for bit against the single-device
    # results above
    stamp(stamps, 'h')
    scale_out(engine, tps, seqs, path, results, hit_off, by_path)

    # (i) the GUI on the card; (j) the entry points and the tools
    stamp(stamps, 'i')
    gui_phase(engine, tps, path, seqs, hit_off, by_path, card)
    stamp(stamps, 'j')
    entry_phase(tps, by_path, card)

    # (k) hitdiff against the C reference; (l) gzipped and paired input
    stamp(stamps, 'k')
    hitdiff_phase(engine, tps, by_path, card)
    stamp(stamps, 'l')
    paired_phase(engine, tps, seqs, windows, path, by_path, card)
    stamp(stamps, 'f')
    faulthandler.cancel_dump_traceback_later()

    # (f) summary
    say('f', 'peak device memory of this process %.2f GB; total %.1fs; '
        'seconds per phase (from its start to the next one\'s): %s' % (
            torch.cuda.max_memory_allocated() / 1e9, time.time() - t_start,
            ', '.join('%s %.1f' % (a, tb - ta) for (a, ta), (_, tb) in
                      zip(stamps, stamps[1:]))))
    print(json.dumps({'kernels': [{
        'name': 'cand_screen', 'route': 'cuda',
        'source': 'kvarq_tpu_torch/csrc/cand_screen.cu',
        'replaces': 'kvarq_tpu/engine/pallas_scan.py:151',
        'launches': launches, 'launches_by_path': by_path,
        'max_abs_err': k1['max_abs_err'], 'ms': k1['ms'],
        'kernel_ms': k1['kernel_ms'], 'plain_ms': k1['plain_ms'],
        'bound_ms': k1['bound_ms'], 'bound_by': k1['bound_by'],
        # no PyTorch call computes the screen: the library column holds the
        # int8 one-hot product alone (torch._int_mm, no screen) as context,
        # matmul_ms the fp16 one
        'library_ms': k1['int_mm_ms'],
        'library_call': 'torch._int_mm of the one-hot product alone',
        'matmul_ms': mm_ms}, {
        'name': 'score_step', 'route': 'cuda',
        'source': 'kvarq_tpu_torch/csrc/score_step.cu',
        # not a TPU kernel: the exact scoring kvarq_tpu leaves to XLA
        # (score_full; score_gathered at :385)
        'replaces': 'kvarq_tpu/engine/pallas_scan.py:362',
        'launches': S1_BY_PATH['countseqs sieve=on'],
        'launches_by_path': S1_BY_PATH,
        'max_abs_err': s1['max_abs_err'], 'ms': s1['dense']['ms'],
        'plain_ms': s1['dense']['plain_ms'],
        'bound_ms': s1['dense']['bound_ms'],
        'bound_by': s1['dense']['bound_by'],
        # no PyTorch call computes the scoring; matmul_ms is the fp16
        # product alone, as context
        'library_ms': None, 'matmul_ms': mm_ms,
        'split': s1['dense']['split'],
        'forms': {k: s1[k] for k in ('dense', 'gathered',
                                     'above_gather_k')}}, {
        'name': 'hit_extract', 'route': 'cuda',
        'source': 'kvarq_tpu_torch/csrc/score_step.cu',
        # not a TPU kernel: the hit extraction kvarq_tpu leaves to XLA
        # (match_xla._jit_step; _jit_rows at :190)
        'replaces': 'kvarq_tpu/engine/match_xla.py:122',
        'launches': H1_BY_PATH['findseqs sieve=off'],
        'launches_by_path': H1_BY_PATH,
        'max_abs_err': h1['gathered']['max_abs_err'],
        'ms': h1['gathered']['ms'], 'plain_ms': h1['gathered']['plain_ms'],
        'bound_ms': h1['gathered']['bound_ms'],
        'bound_by': h1['gathered']['bound_by'],
        # no single PyTorch call computes the extraction; matmul_ms is the
        # fp16 dense product alone, as context
        'library_ms': None, 'matmul_ms': mm_ms,
        'forms': h1}]}),
        flush=True)
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
