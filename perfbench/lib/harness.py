'''
One run of one cell: set-up, the measured window, the traced samples, and
the check of every result against the plain reference.

The window drives the entry each ``kvarq scan`` process runs,
``kvarq_tpu_torch.cli.main(['scan', ..., <fastq>, <json>])``, in this
process, one whole sample after another (a closed loop with one sample in
flight), over the samples made from the seed in turn. Each scan writes
its result to a path of its own; all of them are checked once the window
has closed.
'''

import gc
import importlib
import json
import os
import shutil
import sys
import tempfile
import time

from perfbench.lib import check, generator, program, spec, trace

PROGRAM = 'kvarq_tpu_torch'
# top-level modules no run may hold: JAX, and the JAX package (whose
# name the program's begins with) with the repository's ``bench.py``
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'kvarq_tpu', 'bench')
# device operations are named by their first characters in a breakdown
NAME_CHARS = 100


class Failure(Exception):
    ''' a run that prints no result; ``code`` is its exit code '''

    def __init__(self, code, message):
        super().__init__(message)
        self.code = code


def forbidden_modules(modules=None):
    ''' the loaded modules whose top-level name is forbidden, compared
        whole; ``kvarq`` only as the program's own binding for testsuite
        plugins '''
    modules = sys.modules if modules is None else modules
    found = sorted(n for n in modules if n.split('.')[0] in FORBIDDEN)
    kvarq = modules.get('kvarq')
    if kvarq is not None and kvarq is not modules.get(PROGRAM):
        found.append('kvarq')
    return found


def program_env():
    ''' the environment of the program's run: no ``KVARQ_*`` settings
        from outside '''
    for key in [k for k in os.environ if k.startswith('KVARQ_')]:
        del os.environ[key]


def reference_group(config, root):
    ''' the plain reference of the configuration's testsuites '''
    module = importlib.import_module('perfbench.reference.'
                                     + config['reference'])
    return module.Group(root, config['scan']['spacing'])


def cli_argv(config, traffic, fastq, out, card=True):
    s = config['scan']
    argv = ['scan', '-l', config['testsuites'], '-Q', str(s['quality']),
            '-e', str(s['errors']), '-r', str(s['readlength']),
            '-o', str(s['overlap']), '-s', str(s['spacing']),
            '-t', str(s['threads'])]
    argv += traffic['args']
    if not card:
        argv += ['--backend', 'cpu']
    return argv + ['-f', fastq, out]


class Run:

    def __init__(self, root, cell, config, traffic, seed, seconds,
                 card=True, started=None):
        self.root = root
        self.cell = cell
        self.config = config
        self.traffic = traffic
        self.seed = seed % (1 << 64)
        self.seconds = seconds
        self.card = card
        self.started = time.perf_counter() if started is None else started
        self.scans = []          # (sample, out path, start, end, exit code)
        self.tr = None
        self.window_tr = None    # the window's device activity, if traced
        self.program = None      # the traced samples' spans and counters
        self.torch = None
        self.dir = None

    def say(self, **info):
        ''' an information line, printed before the result '''
        print('perfbench: ' + json.dumps(info), flush=True)

    # --- set-up -----------------------------------------------------------

    def setup(self):
        if importlib.util.find_spec(PROGRAM) is None:
            raise Failure(2, 'the program (%s) is not in this checkout'
                          % PROGRAM)
        program_env()
        if self.card:
            import torch
            self.torch = torch
            need = self.cell['chips']
            if not torch.cuda.is_available():
                raise Failure(3, 'no CUDA device')
            if torch.cuda.device_count() < need:
                raise Failure(3, 'the cell needs %d CUDA devices, %d found'
                              % (need, torch.cuda.device_count()))
        self.dir = os.path.join(tempfile.gettempdir(), 'perfbench',
                                self.cell['name'])
        shutil.rmtree(self.dir, ignore_errors=True)
        os.makedirs(os.path.join(self.dir, 'out'))
        # the benchmark's own work, kept off the set-up clock: the
        # reference's testsuites and the samples made from the seed
        t0 = time.perf_counter()
        self.group = reference_group(self.config, self.root)
        genome = generator.genome_codes(
            os.path.join(self.root, self.config['model']['genome']))
        quals = generator.quality_lines(self.config, self.root)
        self.samples = []
        for index in range(self.traffic['samples']):
            paths, _ = generator.make_sample(
                genome, self.group, self.config, self.seed, index, self.dir,
                quals=quals)
            self.samples.append(paths)
        self.generation_s = time.perf_counter() - t0
        self.say(generation_s=self.generation_s,
                 sample_bytes=[sum(os.path.getsize(p) for p in s)
                               for s in self.samples])
        from kvarq_tpu_torch import cli
        self.cli = cli
        # the warm-up: one whole scan builds the program's libraries and
        # kernels (on a fresh checkout), loads them and grows the
        # process's heap; the other samples have the same layout and
        # shapes
        t0 = time.perf_counter()
        self._scan(0, 'warm')
        self.say(warmup_s=time.perf_counter() - t0)
        self.setup_s = (time.perf_counter() - self.started
                        - self.generation_s)

    def _scan(self, k, tag):
        out = os.path.join(self.dir, 'out', '%s.json' % tag)
        argv = cli_argv(self.config, self.traffic, self.samples[k][0], out,
                        self.card)
        a = time.perf_counter()
        try:
            self.cli.main(argv)
            rc = 0
        except SystemExit as e:
            rc = e.code if isinstance(e.code, int) else 1
        b = time.perf_counter()
        self.scans.append((k, out, a, b, rc))
        return a, b

    # --- the window -----------------------------------------------------------

    def window(self, profiled=False):
        ''' the measured window; ``profiled``: under torch.profiler's
            device activity alone, reduced to ``window_tr`` (for an
            end-to-end metric read from the device's trace) '''
        first = len(self.scans)
        n = len(self.samples)
        prof = None
        if profiled:
            from torch.profiler import ProfilerActivity, profile
            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.start()
        t0 = time.perf_counter()
        i = 0
        # every sample at least once, then until the window's length
        while True:
            _, end = self._scan(i % n, 'r%d' % i)
            i += 1
            if i >= n and end - t0 >= self.seconds:
                break
        self.window_s = end - t0
        self.window_scans = self.scans[first:]
        if self.card:
            torch = self.torch
            self.memory_peak = max(torch.cuda.max_memory_allocated(d)
                                   for d in range(self.cell['chips']))
        if prof is not None:
            t1 = time.perf_counter()
            self.torch.cuda.synchronize()
            prof.stop()
            # the profiler's own events, with no trace file written
            self.window_tr = trace.device_activity(
                prof.profiler.kineto_results.events())
            del prof
            self.say(window_trace_s=time.perf_counter() - t1,
                     window_device_ops=len(self.window_tr['device']))

    def traced_samples(self):
        ''' a few more samples under torch.profiler, each in a span of its
            own, with the program's spans and counters recorded (in these
            samples alone: never in the warm-up or the window) '''
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile, record_function
        from kvarq_tpu_torch import profiling
        from kvarq_tpu_torch.engine import pallas_scan
        counters = {'K1': pallas_scan.cand_counts,
                    'S1': pallas_scan.score_candidates,
                    'H1': pallas_scan.hit_triplets}
        before = {k: c.launches for k, c in counters.items()}
        n = len(self.samples)
        traced = self.traffic['trace_samples']
        path = os.path.join(self.dir, 'trace.json')
        collected = []
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(traced):
                with profiling.recording():
                    with record_function('perfbench.sample.s%d' % (i % n)):
                        self._scan(i % n, 't%d' % i)
                        torch.cuda.synchronize()
                    collected.append(profiling.collect())
        counts = {}
        for c in collected:
            for k, v in c['counts'].items():
                counts[k] = counts.get(k, 0) + v / traced
        self.say(launches_per_sample={
            k: (c.launches - before[k]) / traced for k, c in counters.items()},
            counts_per_sample=counts, max_memory_allocated=self.memory_peak)
        prof.export_chrome_trace(path)
        self.tr = trace.reduce(path)
        os.remove(path)
        self.program = [program.place(c, self.tr['base_ns'])
                        for c in collected]

    # --- the check --------------------------------------------------------------

    def check(self):
        ''' ``({field: differences summed over the scans}, failed scans)``
            against the reference; every scan of the run is checked '''
        gc.collect()
        if self.card:
            self.torch.cuda.empty_cache()
        hits = self.traffic['path'] == 'hits'
        t0 = time.perf_counter()
        device = 'cuda' if self.card else 'cpu'
        want = [check.Expected(p, self.config, self.group, device)
                .result(hits) for p in self.samples]
        reference_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        total = dict.fromkeys(check.FIELDS, 0)
        failed = 0
        self.scantimes = {}
        for k, out, a, b, rc in self.scans:
            got = None
            if rc == 0 and os.path.exists(out):
                with open(out) as fd:
                    got = json.load(fd)
                self.scantimes[out] = got.get('info', {}).get('scantime')
            diff = check.compare(got, want[k])
            failed += any(diff.values())
            for key, v in diff.items():
                total[key] += v
        # the reference's results, then loading and comparing every scan's
        self.say(reference_s=reference_s, check_s=time.perf_counter() - t0)
        return total, failed

    def record(self):
        ''' what the metric readers read '''
        return {
            'reads_per_sample': generator.reads_per_sample(
                self.config['reads']),
            'setup_s': self.setup_s,
            'window_s': self.window_s,
            'scans': [{'sample': k, 'wall_s': b - a,
                       'scantime_s': self.scantimes.get(out), 'rc': rc}
                      for k, out, a, b, rc in self.window_scans],
            'trace': self.tr,
            'window_trace': self.window_tr,
            'program': self.program,
        }

    def cleanup(self):
        if self.dir:
            shutil.rmtree(self.dir, ignore_errors=True)


def execute(root, bench, cell_name, seed, seconds, traced, card=True,
            started=None, config=None, traffic=None):
    ''' one run of a cell; :returns: its result object, ``correct``
        decided over every scan of the run (warm-up, window, traced) and
        the numbers compared, with their limits, under ``checks`` '''
    cell = spec.cell(bench, cell_name)
    config = config or spec.config(cell['config'])
    traffic = traffic or spec.traffic(cell['traffic'])
    run = Run(root, cell, config, traffic, seed, seconds, card, started)
    # the window runs under the profiler only where an end-to-end metric
    # of the cell is read from the device's trace, and never in a traced
    # run, whose window the per-layer metrics read on the host's clock
    profiled = card and not traced and any(
        m['source'] == 'device_trace'
        for m in spec.metrics(bench, cell_name, False))
    try:
        run.setup()
        run.window(profiled)
        if traced and card:
            run.traced_samples()
        diffs, failed = run.check()
    finally:
        run.cleanup()

    record = run.record()
    run.say(scans=[[s['sample'], round(s['wall_s'], 4),
                    s['scantime_s'] and round(s['scantime_s'], 4)]
                   for s in record['scans']])
    metrics = {}
    for m in spec.metrics(bench, cell_name, traced):
        value = spec.reader(m['name'])(record)
        if value is not None:
            metrics[m['name']] = {'value': value, 'unit': m['unit']}
    checks = {k: {'value': v, 'limit': 0} for k, v in diffs.items()}
    result = {
        'correct': failed == 0 and all(v == 0 for v in diffs.values()),
        'attempted': len(run.scans),
        'failed': failed,
        'metrics': metrics,
        'device': device(run, traced),
    }
    if traced and run.tr is not None:
        result['breakdown'] = breakdown(run.tr, run.program)
    result['checks'] = checks
    return result


def device(run, traced):
    if not run.card:
        return {'platform': 'cpu', 'kind': 'cpu', 'count': 0,
                'memory_peak_bytes': 0}
    torch = run.torch
    out = {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
           'count': run.cell['chips'], 'memory_peak_bytes': run.memory_peak}
    if traced and run.tr is not None:
        out['busy_s'] = trace.busy_us(run.tr) / 1e6
        out['window_s'] = trace.window_us(run.tr) / 1e6
    return out


def breakdown(tr, placed=None):
    ops = sorted(trace.us_by_name(tr).items(), key=lambda x: -x[1])
    gaps = sorted(trace.idle_gaps(tr, placed), key=lambda x: -x[1])
    return {'device_ops': [[n[:NAME_CHARS], us / 1e6] for n, us in ops[:10]],
            'idle_gaps': [[n, us / 1e6] for n, us in gaps[:10]]}
