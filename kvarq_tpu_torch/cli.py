'''
The ``kvarq`` command line of the port: ``python -m kvarq_tpu_torch.cli``
(a copy of kvarq_tpu/cli.py with the port's engine behind it).

The whole surface is declared as a data table (``_COMMANDS``) from which
the argparse parser is generated.  ``scan`` (:py:func:`cmd_scan`) runs the
port's engine on a CUDA device (``--backend cuda``, the default), on the
CPU (``--backend cpu``), with the host's numpy matcher (``--backend
numpy``) or, with ``--backend auto``, with numpy on a small input while
CUDA is cold and on the card otherwise; ``-H``/``-x`` run the hit-list
scan;
``--profile`` records phase times and a torch.profiler trace with the
spans of every thread of the scan (kvarq_tpu_torch.profiling);
``--mesh`` shards either path over a ``('data', 'bank')`` device mesh
(kvarq_tpu_torch.parallel).  ``batch`` (:py:func:`cmd_batch`) scans a
corpus, sharded over the processes of a Gloo group
(kvarq_tpu_torch.parallel.multihost) and the devices of each.
``illustrate``, ``show``, ``update``, ``summarize``, ``info`` and
``version`` read and write result files as kvarq_tpu's do.  ``gui`` and
``explorer`` open the port's Tk windows (kvarq_tpu_torch.gui); they import
tkinter when they run, so every other command runs on a host without it.
'''

import argparse
import contextlib
import json
import os
import os.path
import sys
import threading
import time
from pprint import pprint

from kvarq_tpu_torch import VERSION, analyse, engine, genes, profiling
from kvarq_tpu_torch.config import default_config
from kvarq_tpu_torch.fastq import Fastq, FastqFileFormatException
from kvarq_tpu_torch.log import (appendlog, format_traceback, lo, set_debug,
                                 set_warning)
from kvarq_tpu_torch.profiling import ScanProfiler, span
from kvarq_tpu_torch.testsuites import (discover_testsuites, load_testsuites,
                                        update_testsuites)
from kvarq_tpu_torch.util import (JsonSummary, ProgressBar, TextHist,
                                  get_help_path, json_dump)

# exit codes (reference cli.py:25-27)
ERROR_COMMAND_LINE_SWITCH = -1
ERROR_FASTQ_FORMAT_ERROR = -2
ERROR_FILE_EXISTS = -3

DEVICES = ('cuda', 'cpu')
# scan's --backend: a device, or an engine backend (numpy, auto) whose
# device path runs on the card
BACKENDS = DEVICES + ('numpy', 'auto')


# --- shared helpers ---------------------------------------------------------

def _registry(args):
    return discover_testsuites(args.testsuite_directory or [])


def _selected_testsuites(args):
    ''' the testsuites requested via -L / -l against the discovery
        registry '''
    registry = _registry(args)
    selection = registry.keys() if args.select_all else (args.select or [])
    return load_testsuites(registry, selection)


def _testsuites_from_json(args, data):
    ''' re-load (version-checked) the testsuites recorded in a result
        file '''
    testsuites = {}
    update_testsuites(testsuites, data['info']['testsuites'],
                      _registry(args))
    return testsuites


def _refuse_overwrite(path):
    if os.path.exists(path):
        lo.error('will not overwrite file ' + path)
        sys.exit(ERROR_FILE_EXISTS)


def _write_result(data, path):
    with open(path, 'w', encoding='utf-8') as fd:
        json_dump(data, fd)


# --- scan -------------------------------------------------------------------

class ScanSession:

    '''
    drives one scan: the Analyser runs on a worker thread (inside the
    profiler's trace, a no-op without ``--profile``) while the main
    thread polls ``engine.stats()`` once a second for the progress bar and
    for <CTRL-C> handling (one press prints histograms, two presses within
    2 s abort the scan and keep the partial results) -- reference
    cli.py:106-186
    '''

    def __init__(self, analyser, fastq, testsuites, args, prof):
        self.analyser = analyser
        self.fastq = fastq
        self.testsuites = testsuites
        self.args = args
        self.error = None
        self.error_tb = None
        self.prof = prof
        self.worker = threading.Thread(target=self._work,
                                       name='analyse-thread')

    def _work(self):
        # torch.profiler records the thread that starts it: the worker
        # runs the scan inside ``prof.trace()``
        try:
            with self.prof.trace():
                self._scan()
        except Exception as e:
            self.error = e
            self.error_tb = format_traceback(sys.exc_info())

    def _scan(self):
        try:
            self.analyser.spacing = self.args.spacing
            # the hit list is only materialized for -H / --extract-hits;
            # otherwise coverage is accumulated fully on device
            keep_hits = bool(self.args.hits or self.args.extract_hits)
            self.analyser.scan(self.fastq, self.testsuites,
                               do_reverse=not self.args.no_reverse,
                               keep_hits=keep_hits)
        except Exception as e:
            self.error = e
            self.error_tb = format_traceback(sys.exc_info())

    def _print_histograms(self, stats):
        print()
        print(TextHist(title='readlengths').draw(
            list(stats['readlengths']), indexed=True))
        means = sorted(n / len(self.analyser[i])
                       for i, n in enumerate(stats['nseqbasehits']))
        print()
        print(TextHist(title='mean coverages').draw(means, indexed=False))

    def run(self):
        ''' :returns: final ``engine.stats()`` (partial when aborted) '''
        engine.install_sigint_counter()
        bar = ProgressBar(total=1)
        bar.start()
        sys.stderr.write('\n')

        sigints_seen = 0
        last_sigint = time.time()
        self.worker.start()
        while self.worker.is_alive() and self.error is None:
            self.worker.join(1.0)
            stats = engine.stats()
            if not stats['records_parsed']:
                continue

            if self.args.progress:
                bar.update(stats['progress'])
                sys.stderr.write(str(bar))

            if stats['sigints'] > sigints_seen:
                if time.time() - last_sigint < 2.:
                    sys.stderr.write('\n\n*** caught multiple <CTRL-C> '
                                     'within 2s : abort scanning ***')
                    engine.stop()
                    break
                self._print_histograms(stats)
                sigints_seen = stats['sigints']
                last_sigint = time.time()

        self.worker.join()
        if self.error is not None:
            lo.error('could not scan %s : %s [%s]'
                     % (self.args.fastq, str(self.error), self.error_tb))
            sys.exit(ERROR_FASTQ_FORMAT_ERROR)
        sys.stderr.write('\n')
        return engine.stats()


def _fail(msg):
    sys.stderr.write('\n*** %s ***\n\n' % msg)
    sys.exit(ERROR_COMMAND_LINE_SWITCH)


def _backend(args, choices=BACKENDS):
    ''' the checked ``--backend`` and its device, which must exist unless
        the backend is numpy.  Without the flag: ``$KVARQ_BACKEND`` where
        ``choices`` has it, else the card.
        :returns: ``(backend, device)`` '''
    backend = args.backend or os.environ.get('KVARQ_BACKEND', 'cuda')
    if backend in engine._COUNTERPARTS:
        _fail("--backend %s is kvarq_tpu's; the port's counterpart is "
              "--backend %s" % (backend, 'cpu' if backend == 'xla'
                                else 'cuda'))
    if backend not in choices:
        backend = 'cuda'
    dev = 'cpu' if backend == 'cpu' else 'cuda'
    if backend != 'numpy':
        # torch is imported where a device is selected: the numpy backend
        # and the commands that read result files never import it
        try:
            from kvarq_tpu_torch import device
            device.select(dev)
        except ImportError as e:
            _fail('--backend %s needs torch (%s)' % (backend, e))
        except RuntimeError as e:
            _fail(e)
    return backend, dev


def _configure_backend(backend, dev):
    ''' the engine on ``dev``, through the numpy or auto path when
        ``backend`` names one '''
    engine.config(device=dev, backend=backend if backend in ('numpy', 'auto')
                  else 'device')


def _testsuites(args):
    testsuites = _selected_testsuites(args)
    if not testsuites:
        sys.stderr.write('\n*** you must specify at least one testsuite!'
                         ' ***\n\n(use the -t command line switch)\n\n')
        sys.exit(ERROR_COMMAND_LINE_SWITCH)
    return testsuites


def cmd_scan(args):
    # --profile records the spans of every thread for its trace
    with (profiling.recording() if args.profile
          else contextlib.nullcontext()):
        _run_scan(args)


def _run_scan(args):
    backend, dev = _backend(args)
    mesh = None
    if args.mesh:
        # checked here, so that a bad spec exits before the scan starts
        from kvarq_tpu_torch import parallel
        try:
            mesh = parallel.parse_mesh(args.mesh, dev)
        except (RuntimeError, ValueError) as e:
            _fail(e)
    with span('cli.load'):
        testsuites = _testsuites(args)
        try:
            fastq = Fastq(args.fastq, paired=not args.no_paired,
                          variant=args.variant)
        except FastqFileFormatException as e:
            lo.error('cannot open file %s : %s' % (args.fastq, str(e)))
            sys.exit(ERROR_FASTQ_FORMAT_ERROR)

    engine.config(nthreads=args.threads,
                  maxerrors=args.errors,
                  Amin=fastq.Q2A(args.quality),
                  Azero=fastq.Azero,
                  minreadlength=args.readlength,
                  minoverlap=args.overlap)
    _configure_backend(backend, dev)
    if mesh is not None:
        # -H/-x with a mesh run the sharded screen (ShardedMatcher): hits
        # identical to the unsharded scan
        engine.config(mesh=mesh)

    if not args.force:
        _refuse_overwrite(args.json)
        if args.extract_hits:
            _refuse_overwrite(args.extract_hits)

    lo.info('scanning {} ({}) on {}...'.format(
        ', '.join(fastq.filenames()),
        ', '.join('%.2f MB' % (size / 1024. ** 2)
                  for size in fastq.filesizes()), backend))
    started = time.time()

    prof = ScanProfiler(args.profile, dev)
    if args.profile:
        prof.start()

    analyser = analyse.Analyser()
    with prof.phase('scan'):
        stats = ScanSession(analyser, fastq, testsuites, args, prof).run()

    lo.info('performed scanning of %.2f%% (%smb/%smb, %d records) '
            'in %.3f seconds'
            % (1e2 * stats['progress'], stats['parsed'] // 1024 ** 2,
               stats['total'] // 1024 ** 2, stats['records_parsed'],
               time.time() - started))

    with prof.phase('analyse'):
        analyser.update_testsuites()
    if args.profile:
        analyser.phases = prof.stop()
        lo.info('phases: %s' % ' '.join(
            '%s=%.3fs' % kv for kv in sorted(prof.phases.items())))
    with span('cli.write'):
        _write_result(analyser.encode(hits=args.hits), args.json)
    if args.extract_hits:
        analyser.extract_hits(args.extract_hits)


# --- batch (corpus) scan -----------------------------------------------------

def pair_fastqs(fastqs):
    ''' sort the files and merge ``X_1.fastq``/``X_2.fastq`` neighbours
        into single paired scans; :returns: ``(files, paired_flags)``.
        (A copy of ``kvarq_tpu.gui.simple.pair_fastqs``, kept here so that
        ``batch`` needs no tkinter; the port's GUI imports it from here.) '''
    ordered = sorted(fastqs)
    files, paired = [], []
    i = 0
    while i < len(ordered):
        stem = ordered[i][:ordered[i].rindex('.fastq')]
        mate_found = False
        if i + 1 < len(ordered) and len(stem) > 2 and stem.endswith('_1'):
            next_stem = ordered[i + 1][:ordered[i + 1].rindex('.fastq')]
            mate_found = next_stem == stem[:-2] + '_2'
        files.append(ordered[i])
        paired.append(mate_found)
        i += 2 if mate_found else 1
    return files, paired


def cmd_batch(args):
    ''' scan a corpus of FastQ files (kvarq_tpu's ``batch``): ONE merged
        result json by default, treating the files as shards of one
        sample; with ``--per-sample`` one json per sample plus
        ``summary.csv``, resumable with ``--resume``.  Run the SAME command
        in every process of a multi-process run (``KVARQ_COORDINATOR``,
        ``KVARQ_NUM_PROCESSES``, ``KVARQ_PROCESS_ID``); each process scans
        its own file shard on its share of its host's cards
        (:py:func:`kvarq_tpu_torch.parallel.multihost.local_mesh`) and
        process 0 writes the results. '''
    _, dev = _backend(args, DEVICES)
    testsuites = _testsuites(args)
    try:
        # quality variant / Azero are inferred from the first file
        fastq0 = Fastq(args.fastq[0], paired=False, variant=args.variant)
    except FastqFileFormatException as e:
        lo.error('cannot open file %s : %s' % (args.fastq[0], str(e)))
        sys.exit(ERROR_FASTQ_FORMAT_ERROR)

    engine.config(nthreads=args.threads,
                  maxerrors=args.errors,
                  Amin=fastq0.Q2A(args.quality),
                  Azero=fastq0.Azero,
                  minreadlength=args.readlength,
                  minoverlap=args.overlap)
    # batch scans on its device, whatever the engine's backend key says
    _configure_backend(dev, dev)
    if args.per_sample:
        _batch_per_sample(args, testsuites)
        return
    if not args.force:
        _refuse_overwrite(args.json)

    from kvarq_tpu_torch.engine import reader
    from kvarq_tpu_torch.engine.encode import fold_into_coverage
    from kvarq_tpu_torch.parallel import multihost
    pid, nproc = multihost.initialize()
    lo.info('batch scan: %d files over %d process(es)'
            % (len(args.fastq), nproc))

    analyser = analyse.Analyser()
    analyser.spacing = args.spacing
    analyser.testsuites = testsuites
    analyser.coverages = analyser.load_coverages(testsuites,
                                                 spacing=args.spacing)
    analyser.config = engine.get_config()
    seqs = [c.plus_seq.bases for c in analyser.coverages.values()]
    do_reverse = not args.no_reverse
    if do_reverse:
        seqs += [c.minus_seq.bases for c in analyser.coverages.values()]

    started = time.time()
    stats = reader.ReaderStats()
    covs, seqhits, seqbasehits = multihost.scan_sharded(
        list(args.fastq), seqs, maxerrors=args.errors,
        minoverlap=args.overlap, minreadlength=args.readlength,
        Amin=fastq0.Q2A(args.quality), nthreads=args.threads, stats=stats,
        device=dev)
    analyser.scantime = time.time() - started

    n = len(analyser.coverages)
    for i, coverage in enumerate(analyser.coverages.values()):
        fold_into_coverage(coverage, covs[i],
                           covs[n + i] if do_reverse else None)

    longest = min(int(stats.rls_longest), reader.MAX_READLENGTH - 1)
    analyser.stats = {
        'readlengths': tuple(int(x) for x in stats.rls[:longest + 1]),
        'progress': 1.0,
        'nseqbasehits': tuple(int(x) for x in seqbasehits),
        'nseqhits': tuple(int(x) for x in seqhits),
        'parsed': int(stats.parsed),
        'total': int(stats.total),
        'sigints': 0,
        'records_parsed': int(stats.records_parsed),
    }
    analyser.fastq_filenames = list(args.fastq)
    analyser.fastq_sizes = [os.path.getsize(f) if os.path.exists(f) else 0
                            for f in args.fastq]
    analyser.fastq_readlength = fastq0.readlength
    analyser.fastq_records_approx = None

    lo.info('scanned %d records (%d mb) in %.3f seconds'
            % (analyser.stats['records_parsed'],
               analyser.stats['parsed'] // 1024 ** 2, analyser.scantime))
    analyser.update_testsuites()
    if pid == 0:
        _write_result(analyser.encode(), args.json)
    else:
        lo.info('process %d: results identical to process 0; not writing'
                % pid)


def _batch_per_sample(args, testsuites):
    ''' one result json per input sample, the samples sharded over the
        processes by file size.  Every json is written atomically (tmp +
        rename) and ``--resume`` skips samples whose output already decodes
        as a kvarq result.  Process 0 ends by summarizing every result into
        ``summary.csv`` (the table of ``kvarq summarize``). '''
    from kvarq_tpu_torch.parallel import multihost
    outdir = args.json
    pid, nproc = multihost.initialize()
    os.makedirs(outdir, exist_ok=True)

    # names that pair_fastqs/Fastq cannot handle fail up front (the rest
    # of the batch still runs; the exit code reports the failures)
    failed = [f for f in args.fastq
              if '.fastq' not in os.path.basename(f)]
    for fname in failed:
        lo.error('skipping %s : not a .fastq[.gz] file' % fname)
    inputs = [f for f in args.fastq if '.fastq' in os.path.basename(f)]

    if args.no_paired:
        files, paireds = inputs, [False] * len(inputs)
    else:
        files, paireds = pair_fastqs(inputs)

    # one output per sample, keyed by basename; same-named files from
    # different directories get deterministic _2/_3... suffixes
    seen = {}
    outs = []
    for fname in files:
        base = os.path.basename(fname)
        for suffix in ('.fastq.gz', '.fastq'):
            if base.endswith(suffix):
                base = base[:-len(suffix)]
                break
        n = seen.get(base, 0)
        seen[base] = n + 1
        outs.append(os.path.join(
            outdir, base + ('' if n == 0 else '_%d' % (n + 1)) + '.json'))

    def is_done(path):
        try:
            with open(path, encoding='utf-8') as fd:
                return json.load(fd)['info']['format'] == 'kvarq'
        except (OSError, ValueError, KeyError, TypeError):
            return False

    if not args.force and not args.resume:
        for out in outs:
            _refuse_overwrite(out)

    # by index, so that a file listed twice is scanned once per listing
    # (kvarq_tpu's assignment by name gives both listings to every process
    # that owns either)
    mine = set(multihost.shard_file_indices(files, pid, nproc))
    lo.info('batch scan: %d sample(s), %d assigned to process %d/%d'
            % (len(files), len(mine), pid, nproc))
    scanned, resumed = 0, 0
    for k, (fname, is_paired, out) in enumerate(zip(files, paireds, outs)):
        if k not in mine:
            continue
        if args.resume and is_done(out):
            resumed += 1
            continue
        started = time.time()
        try:
            fastq = Fastq(fname, variant=args.variant, paired=is_paired)
            engine.config(Amin=fastq.Q2A(args.quality), Azero=fastq.Azero)
            analyser = analyse.Analyser()
            analyser.spacing = args.spacing
            analyser.scan(fastq, testsuites,
                          do_reverse=not args.no_reverse, keep_hits=False)
        except FastqFileFormatException as e:
            lo.error('skipping %s : %s' % (fname, str(e)))
            failed.append(fname)
            continue
        analyser.update_testsuites()
        tmp = out + '.tmp'
        _write_result(analyser.encode(), tmp)
        os.replace(tmp, out)
        scanned += 1
        lo.info('%s: %d records in %.3fs -> %s'
                % (fname, analyser.stats['records_parsed'],
                   time.time() - started, out))

    lo.info('process %d/%d: scanned %d sample(s), resumed past %d, '
            '%d failed' % (pid, nproc, scanned, resumed, len(failed)))

    # every process finishes its shard before process 0 summarizes
    if nproc > 1:
        import torch.distributed
        torch.distributed.barrier()
    if pid == 0:
        summary = JsonSummary()
        for out in outs:
            if is_done(out):
                summary.add(out)
        spath = os.path.join(outdir, 'summary.csv')
        with open(spath, 'w', encoding='utf-8', newline='') as fd:
            summary.dump(fd)
        lo.info('summary: %s' % spath)
    if failed:
        sys.exit(ERROR_FASTQ_FORMAT_ERROR)


# --- other commands ---------------------------------------------------------

def cmd_version(args):
    print(VERSION)


def cmd_show(args):
    fastq = Fastq(args.file)

    if args.quality:
        lo.info('determining readlengths with quality>=%d of %s '
                'by reading %d records at %d points'
                % (args.quality, args.file, args.number, args.points))
        trimmed = fastq.lengths(fastq.Q2A(args.quality),
                                n=args.number, points=args.points)
        print(TextHist().draw(sorted(trimmed)))

    if args.info:
        print('dQ=' + str(fastq.dQ))
        print('variants=' + str(fastq.variants))
        print('readlength=' + str(fastq.readlength))
        print('records_approx=' + str(fastq.records_approx or '?'))


def cmd_update(args):
    if args.fastq:
        lo.warning('re-reading of hits not currently implemented')

    with open(args.json) as fd:
        data = json.load(fd)
    testsuites = _testsuites_from_json(args, data)

    analyser = analyse.Analyser()
    analyser.decode(testsuites, data)
    analyser.update_testsuites()

    lo.info('re-wrote results to file ' + args.json)
    with open(args.json, 'w', encoding='utf-8') as fd:
        json.dump(analyser.encode(hits=analyser.hits is not None), fd,
                  indent=2)


def cmd_summarize(args):
    summary = JsonSummary()
    for fname in args.json:
        lo.info('processing ' + fname)
        summary.add(fname)
    summary.dump()


def cmd_illustrate(args):
    with open(args.file) as fd:
        data = json.load(fd)
    testsuites = _testsuites_from_json(args, data)

    analyser = analyse.Analyser()
    lo.info('loading json-file ' + args.file)
    analyser.decode(testsuites, data)
    lo.info('updating testsuites')
    analyser.update_testsuites()

    if args.readlengths:
        print(TextHist().draw(analyser.stats['readlengths'], indexed=True))

    if args.coverage:
        for name, testsuite in analyser.testsuites.items():
            print(name + ':')
            for test in testsuite.tests:
                print('  - %s : %s' % (test, analyser[test]))
            print()

    if args.results:
        for name, results in analyser.results.items():
            print('\n' + name)
            print('-' * len(name))
            pprint(results)


def cmd_info(args):
    testsuites = _selected_testsuites(args)

    print('version=' + VERSION)
    descriptions = []
    total_bp = total_tests = 0
    for name, testsuite in testsuites.items():
        bp = 0
        for test in testsuite.tests:
            if isinstance(test.template, genes.DynamicTemplate):
                bp += len(test.template.seq(spacing=args.spacing))
            else:
                bp += len(test.template.seq())
        descriptions.append('%s-%s[%d:%dbp]'
                            % (name, testsuite.version,
                               len(testsuite.tests), bp))
        total_bp += bp
        total_tests += len(testsuite.tests)
    print('testsuites=' + ','.join(descriptions))
    print('sum=%d tests,%dbp' % (total_tests, total_bp))
    print('sys.prefix=' + sys.prefix)


def cmd_gui(args):
    registry = _registry(args)
    import tkinter
    from kvarq_tpu_torch.gui.main import MainGUI
    MainGUI(testsuite_paths=registry)
    tkinter.mainloop()


def cmd_explorer(args):
    registry = _registry(args)
    import tkinter
    from kvarq_tpu_torch.gui.explorer import DirectoryExplorer, JsonExplorer
    explorer_cls = (DirectoryExplorer if os.path.isdir(args.explorable)
                    else JsonExplorer)
    explorer_cls(args.explorable, testsuites={}, testsuite_paths=registry)
    tkinter.mainloop()


# --- command table ----------------------------------------------------------

def _arg(*names, **kwargs):
    return names, kwargs


def _testsuite_selection_args():
    return [
        _arg('-L', '--select-all', action='store_true',
             help='load all discovered testsuites'),
        _arg('-l', '--select', action='append',
             help='name of a testsuite ("MTBC/phylo"), a group ("MTBC"), '
                  'or the path of a testsuite .py file'),
    ]


def _spacing_arg():
    return _arg('-s', '--spacing', action='store', type=int,
                default=default_config['spacing'],
                help='default flank length on both sides of templates '
                     'generated from genome (default=%d)'
                     % default_config['spacing'])


_GLOBAL_ARGS = [
    _arg('-d', '--debug', action='store_true',
         help='output log information at a debug level'),
    _arg('-q', '--quiet', action='store_true',
         help='only output warnings/errors to stderr/log'),
    _arg('-x', '--excepthook', action='store_true',
         help='catch exception and launch debugger'),
    _arg('-l', '--log',
         help='append log to specified file (similar to redirecting '
              'stderr, but without progress bar)'),
    _arg('-t', '--testsuite-directory', action='append',
         help='specify a directory that contains subdirectories from '
              'which testsuites can be loaded; these are added to the '
              'pool of testsuites that can later be selected (scan, info) '
              'or that are autoloaded (illustrate, explore, update)'),
]

# (name, parser kwargs, handler, [argument specs])
_COMMANDS = [

    ('version', dict(help='show version info'), cmd_version, []),

    ('scan', {}, cmd_scan, [
        _arg('-p', '--progress', action='store_true',
             help='shows progress bar on stdout while scanning'),
        # accepted but without effect, exactly like the reference: the
        # flag is declared (cli.py:399-400) yet never read -- use `kvarq
        # update` to recompute analyses from a previous scan's coverages
        _arg('-S', '--no-scan', action='store_true',
             help='instead of scanning the original file, the provided '
                  '.json file from a previous scan result is used'),
        *_testsuite_selection_args(),
        _arg('-t', '--threads', action='store', type=int,
             default=default_config['threads'],
             help='number of threads for concurrent scanning (default: %d)'
                  % default_config['threads']),
        _arg('-Q', '--quality', action='store', type=int,
             default=default_config['quality'],
             help='discard nucleotides with Q score inferior to this '
                  'value (default=%d; i.e. p=0.05)'
                  % default_config['quality']),
        _arg('-e', '--errors', action='store', type=int,
             default=default_config['errors'],
             help='maximal number of errors allowed when comparing base '
                  'sequences (default=%d)' % default_config['errors']),
        _arg('-r', '--readlength', action='store', type=int,
             default=default_config['minimum readlength'],
             help='minimum read length (default=%d)'
                  % default_config['minimum readlength']),
        _arg('-o', '--overlap', action='store', type=int,
             default=default_config['minimum overlap'],
             help='minimum read overlap (default=%d)'
                  % default_config['minimum overlap']),
        _spacing_arg(),
        _arg('-1', '--no-reverse', action='store_true',
             help='do not scan for hits in reverse strand'),
        _arg('-P', '--no-paired', action='store_true',
             help='ignore paired file -- by default, the file '
                  '"strain_2.fastq[.gz]" is also read if '
                  '"strain_1.fastq[.gz]" is specified'),
        _arg('--variant', choices=list(Fastq.vendor_variants.keys()),
             help='specify .fastq variant manually in case heuristic '
                  'determination fails'),
        # kvarq_tpu's backend names parse too, so that cmd_scan can say
        # why they are refused
        _arg('--backend',
             choices=list(BACKENDS) + list(engine._COUNTERPARTS),
             help='cuda (default): the card; cpu; numpy: the byte-exact '
                  'matcher on the host; auto: numpy for an input under 4 '
                  'MB ($KVARQ_SMALL_SCAN) while CUDA is cold, the card '
                  'otherwise (default: $KVARQ_BACKEND where it names one '
                  'of these, else cuda)'),
        _arg('--mesh',
             help='scan sharded over a device mesh: "auto" (every card on '
                  'the data axis) or "NDxNB" for an explicit (data, bank) '
                  'shape, e.g. "2x2"; with -H/-x the candidate screen runs '
                  'sharded'),
        _arg('--profile', metavar='DIR',
             help='record per-phase wall times into the result json '
                  '(info.phases) and write a torch.profiler trace of the '
                  'host and the card to DIR, with the spans of every '
                  'thread of the scan (the reader\'s among them)'),
        _arg('-f', '--force', action='store_true',
             help='overwrite any existing .json file'),
        _arg('-H', '--hits', action='store_true',
             help='saves all hits in .json file'),
        _arg('-x', '--extract_hits',
             help='stores the fastq records of all hits in specified '
                  'file'),
        _arg('fastq', help='name of .fastq file to scan'),
        _arg('json', help='name of .json file to where results are '
                          'stored (or loaded, see -S)'),
    ]),

    ('batch', dict(
        help='scan a corpus of .fastq files, sharded over all hosts and '
             'chips: ONE merged result .json by default, or one .json per '
             'sample plus summary.csv with --per-sample (kvarq_tpu '
             'extension: first-class replacement for looping "kvarq scan" '
             'in a shell and merging with "summarize")'),
     cmd_batch, [
        *_testsuite_selection_args(),
        _arg('--per-sample', action='store_true',
             help='treat every input as a separate sample: write one '
                  'result .json per sample (plus summary.csv) into the '
                  'JSON output *directory* instead of one merged result'),
        _arg('--resume', action='store_true',
             help='with --per-sample: skip samples whose result .json '
                  'already exists and is valid (restart an interrupted '
                  'batch where it stopped)'),
        _arg('-P', '--no-paired', action='store_true',
             help='with --per-sample: do not merge X_1/X_2 .fastq '
                  'neighbors into single paired scans'),
        _arg('-t', '--threads', action='store', type=int,
             default=default_config['threads'],
             help='number of reader threads per host (default: %d)'
                  % default_config['threads']),
        _arg('-Q', '--quality', action='store', type=int,
             default=default_config['quality'],
             help='discard nucleotides with Q score inferior to this '
                  'value (default=%d)' % default_config['quality']),
        _arg('-e', '--errors', action='store', type=int,
             default=default_config['errors'],
             help='maximal number of errors allowed when comparing base '
                  'sequences (default=%d)' % default_config['errors']),
        _arg('-r', '--readlength', action='store', type=int,
             default=default_config['minimum readlength'],
             help='minimum read length (default=%d)'
                  % default_config['minimum readlength']),
        _arg('-o', '--overlap', action='store', type=int,
             default=default_config['minimum overlap'],
             help='minimum read overlap (default=%d)'
                  % default_config['minimum overlap']),
        _spacing_arg(),
        _arg('-1', '--no-reverse', action='store_true',
             help='do not scan for hits in reverse strand'),
        _arg('--variant', choices=list(Fastq.vendor_variants.keys()),
             help='specify .fastq variant manually (inferred from the '
                  'first file otherwise)'),
        _arg('-f', '--force', action='store_true',
             help='overwrite any existing .json file'),
        _arg('fastq', nargs='+', help='the .fastq file corpus to scan'),
        _arg('json', help='name of the merged result .json file'),
        _arg('--backend', choices=DEVICES,
             help='compute device of the port: cuda (default) or cpu'),
    ]),

    ('update', dict(
        help='update (re-calculate) testsuites based on coverages saved '
             'in .json file; result is stored in same file'),
     cmd_update, [
        _arg('json', help='name of .json file to update'),
        _arg('fastq', nargs='?',
             help='also re-calculate coverages with .fastq file '
                  'specified'),
    ]),

    ('show', dict(help='show some information about a .fastq file'),
     cmd_show, [
        _arg('-n', '--number', action='store', default=10000, type=int,
             help='number of records to read (applies to -Q)'),
        _arg('-p', '--points', action='store', default=10, type=int,
             help='number of points in file where to sample'),
        _arg('-Q', '--quality', action='store', default=0, type=int,
             help='show histogram of readlengths with given quality '
                  'cutoff'),
        _arg('-i', '--info', action='store_true',
             help='output some information about FastQ file'),
        _arg('file', help='name of .fastq file to analyze'),
    ]),

    ('summarize', dict(
        help='reads several .json files and summarizes the results to '
             'standard output in .csv format'),
     cmd_summarize, [
        _arg('json', nargs='+', help='input .json files'),
    ]),

    ('illustrate', dict(
        help='illustrate some information contained in a .json file'),
     cmd_illustrate, [
        _arg('-l', '--readlengths', action='store_true',
             help='show a histogram of readlengths'),
        _arg('-c', '--coverage', action='store_true',
             help='show tests/coverages sorted by testsuite'),
        _arg('-r', '--results', action='count',
             help='shows results of analyses'),
        _arg('file', help='name of .json file to illustrate'),
    ]),

    ('gui', dict(help='start GUI'), cmd_gui, []),

    ('info', dict(help='show infos about kvarq'), cmd_info, [
        *_testsuite_selection_args(),
        _spacing_arg(),
    ]),

    ('explorer', dict(help='launches the directory/json explorer'),
     cmd_explorer, [
        _arg('explorable', help='directory/.json file to explore'),
    ]),
]


def build_parser():
    parser = argparse.ArgumentParser(description='''

            analyse .fastq file and report specific mutations in a .json
            file (PyTorch/CUDA port); additional output is displayed on
            stdout and log information is printed on stderr -- for
            additional see %s

        ''' % get_help_path())
    for names, kwargs in _GLOBAL_ARGS:
        parser.add_argument(*names, **kwargs)

    subparsers = parser.add_subparsers(help='main command to execute')
    for name, parser_kwargs, handler, arguments in _COMMANDS:
        sub = subparsers.add_parser(name, **parser_kwargs)
        sub.set_defaults(func=handler)
        for names, kwargs in arguments:
            sub.add_argument(*names, **kwargs)
    return parser


parser = build_parser()


def _debugger_excepthook(type_, value, tb):
    ''' drop into pdb post-mortem on uncaught exceptions (-x flag) '''
    if hasattr(sys, 'ps1') or not sys.stderr.isatty():
        sys.__excepthook__(type_, value, tb)
        return
    import pdb
    import traceback
    traceback.print_exception(type_, value, tb)
    print()
    pdb.post_mortem(tb)


# backwards-compatible alias (reference cli.py:35-43)
traceit = _debugger_excepthook


def main(argv=None):
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)

    assert not (args.debug and args.quiet), \
        'make up your mind: debug OR normal OR quiet'
    if args.debug:
        set_debug()
    if args.quiet:
        set_warning()
    if args.log:
        appendlog(args.log)
    if args.excepthook:
        sys.excepthook = _debugger_excepthook

    if not hasattr(args, 'func'):
        parser.print_usage()
        sys.exit(ERROR_COMMAND_LINE_SWITCH)
    args.func(args)


if __name__ == '__main__':
    main(sys.argv[1:])
