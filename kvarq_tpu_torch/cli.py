'''
The ``kvarq`` command line of the port: ``python -m kvarq_tpu_torch.cli``.

The parser is kvarq_tpu's own (``kvarq_tpu.cli._COMMANDS`` /
``_GLOBAL_ARGS``) with ``scan`` rebound to :py:func:`cmd_scan`, which
runs the port's engine on a CUDA device (``--backend cuda``, the default)
or on the CPU (``--backend cpu``).  Subcommands that read result files
(``illustrate``, ``show``, ``update``, ``summarize``, ``info``,
``version``, ``explorer``) are reused as they are; ``gui`` is not yet
ported and exits with a message.  ``-H``/``-x`` run the hit-list scan;
``--profile`` records phase times and a torch.profiler trace
(kvarq_tpu_torch.profiling); ``--mesh`` shards either path over a
``('data', 'bank')`` device mesh (kvarq_tpu_torch.parallel).  ``batch``
(:py:func:`cmd_batch`) scans a corpus, sharded over the processes of a
Gloo group (kvarq_tpu_torch.parallel.multihost) and the devices of each.
'''

import argparse
import json
import os
import sys
import time

from kvarq_tpu import cli as kcli
from kvarq_tpu.fastq import Fastq, FastqFileFormatException
from kvarq_tpu.log import (appendlog, format_traceback, lo, set_debug,
                           set_warning)
from kvarq_tpu.util import JsonSummary, ProgressBar, get_help_path
from kvarq_tpu_torch import analyse, device, engine, parallel
from kvarq_tpu_torch.parallel import multihost
from kvarq_tpu_torch.profiling import ScanProfiler

BACKENDS = ('cuda', 'cpu')


def _refuse(what):
    sys.stderr.write('\n*** %s is not yet ported to kvarq_tpu_torch; use '
                     'python -m kvarq_tpu.cli ***\n\n' % what)
    sys.exit(kcli.ERROR_COMMAND_LINE_SWITCH)


class ScanSession(kcli.ScanSession):

    ''' kvarq_tpu's scan session (worker thread plus progress and <CTRL-C>
        handling), polling the port's engine; the worker runs the scan
        inside ``prof.trace()`` (torch.profiler records the thread that
        starts it) '''

    def __init__(self, analyser, fastq, testsuites, args, prof):
        super().__init__(analyser, fastq, testsuites, args)
        self.prof = prof

    def _work(self):
        # the scan's own errors are caught by kvarq_tpu's _work; this
        # catches the trace's
        try:
            with self.prof.trace():
                super()._work()
        except Exception as e:
            self.error = e
            self.error_tb = format_traceback(sys.exc_info())

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
            sys.exit(kcli.ERROR_FASTQ_FORMAT_ERROR)
        sys.stderr.write('\n')
        return engine.stats()


def _fail(msg):
    sys.stderr.write('\n*** %s ***\n\n' % msg)
    sys.exit(kcli.ERROR_COMMAND_LINE_SWITCH)


def _backend(args):
    ''' the checked ``--backend`` (default cuda) '''
    backend = args.backend or 'cuda'
    if backend not in BACKENDS:
        _refuse('--backend %s (the port runs %s)'
                % (backend, ' or '.join(BACKENDS)))
    try:
        device.select(backend)
    except RuntimeError as e:
        _fail(e)
    return backend


def _testsuites(args):
    testsuites = kcli._selected_testsuites(args)
    if not testsuites:
        sys.stderr.write('\n*** you must specify at least one testsuite!'
                         ' ***\n\n(use the -t command line switch)\n\n')
        sys.exit(kcli.ERROR_COMMAND_LINE_SWITCH)
    return testsuites


def cmd_scan(args):
    backend = _backend(args)
    mesh = None
    if args.mesh:
        # checked here, so that a bad spec exits before the scan starts
        try:
            mesh = parallel.parse_mesh(args.mesh, backend)
        except (RuntimeError, ValueError) as e:
            _fail(e)
    testsuites = _testsuites(args)

    try:
        fastq = Fastq(args.fastq, paired=not args.no_paired,
                      variant=args.variant)
    except FastqFileFormatException as e:
        lo.error('cannot open file %s : %s' % (args.fastq, str(e)))
        sys.exit(kcli.ERROR_FASTQ_FORMAT_ERROR)

    engine.config(nthreads=args.threads,
                  maxerrors=args.errors,
                  Amin=fastq.Q2A(args.quality),
                  Azero=fastq.Azero,
                  minreadlength=args.readlength,
                  minoverlap=args.overlap,
                  device=backend)
    if mesh is not None:
        # -H/-x with a mesh run the sharded screen (ShardedMatcher): hits
        # identical to the unsharded scan
        engine.config(mesh=mesh)

    if not args.force:
        kcli._refuse_overwrite(args.json)
        if args.extract_hits:
            kcli._refuse_overwrite(args.extract_hits)

    lo.info('scanning {} ({}) on {}...'.format(
        ', '.join(fastq.filenames()),
        ', '.join('%.2f MB' % (size / 1024. ** 2)
                  for size in fastq.filesizes()), backend))
    started = time.time()

    prof = ScanProfiler(args.profile, backend)
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
    kcli._write_result(analyser.encode(hits=args.hits), args.json)
    if args.extract_hits:
        analyser.extract_hits(args.extract_hits)


# --- batch (corpus) scan -----------------------------------------------------

def pair_fastqs(fastqs):
    ''' sort the files and merge ``X_1.fastq``/``X_2.fastq`` neighbours
        into single paired scans; :returns: ``(files, paired_flags)``.
        (A copy of ``kvarq_tpu.gui.simple.pair_fastqs``, whose module
        needs tkinter.) '''
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
    backend = _backend(args)
    testsuites = _testsuites(args)
    try:
        # quality variant / Azero are inferred from the first file
        fastq0 = Fastq(args.fastq[0], paired=False, variant=args.variant)
    except FastqFileFormatException as e:
        lo.error('cannot open file %s : %s' % (args.fastq[0], str(e)))
        sys.exit(kcli.ERROR_FASTQ_FORMAT_ERROR)

    engine.config(nthreads=args.threads,
                  maxerrors=args.errors,
                  Amin=fastq0.Q2A(args.quality),
                  Azero=fastq0.Azero,
                  minreadlength=args.readlength,
                  minoverlap=args.overlap,
                  device=backend)
    if args.per_sample:
        _batch_per_sample(args, testsuites)
        return
    if not args.force:
        kcli._refuse_overwrite(args.json)

    from kvarq_tpu.engine import reader
    from kvarq_tpu.engine.tensor_scan import fold_into_coverage
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
        device=backend)
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
        kcli._write_result(analyser.encode(), args.json)
    else:
        lo.info('process %d: results identical to process 0; not writing'
                % pid)


def _batch_per_sample(args, testsuites):
    ''' one result json per input sample, the samples sharded over the
        processes by file size.  Every json is written atomically (tmp +
        rename) and ``--resume`` skips samples whose output already decodes
        as a kvarq result.  Process 0 ends by summarizing every result into
        ``summary.csv`` (the table of ``kvarq summarize``). '''
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
            kcli._refuse_overwrite(out)

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
        kcli._write_result(analyser.encode(), tmp)
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
        sys.exit(kcli.ERROR_FASTQ_FORMAT_ERROR)


def _not_ported(name):
    def handler(args):
        _refuse(name)
    return handler


def build_parser():
    parser = argparse.ArgumentParser(description='''

            analyse .fastq file and report specific mutations in a .json
            file (PyTorch/CUDA port); additional output is displayed on
            stdout and log information is printed on stderr -- for
            additional see %s

        ''' % get_help_path())
    for names, kwargs in kcli._GLOBAL_ARGS:
        parser.add_argument(*names, **kwargs)

    handlers = {'scan': cmd_scan, 'batch': cmd_batch,
                'gui': _not_ported('gui')}
    subparsers = parser.add_subparsers(help='main command to execute')
    for name, parser_kwargs, handler, arguments in kcli._COMMANDS:
        sub = subparsers.add_parser(name, **parser_kwargs)
        sub.set_defaults(func=handlers.get(name, handler))
        for names, kwargs in arguments:
            if '--backend' in names:
                # every kvarq_tpu backend name parses, so that cmd_scan can
                # say why it is refused
                kwargs = dict(
                    kwargs, choices=list(BACKENDS) + list(kwargs['choices']),
                    help='compute device of the port: cuda (default) or '
                         'cpu')
            elif '--profile' in names:
                kwargs = dict(
                    kwargs, help='record per-phase wall times into the '
                    'result json (info.phases) and write a torch.profiler '
                    'trace of the host and the card to DIR')
            elif '--mesh' in names:
                kwargs = dict(
                    kwargs, help='scan sharded over a device mesh: "auto" '
                    '(every card on the data axis) or "NDxNB" for an '
                    'explicit (data, bank) shape, e.g. "2x2"; with -H/-x the '
                    'candidate screen runs sharded')
            sub.add_argument(*names, **kwargs)
        if name == 'batch':
            sub.add_argument('--backend', choices=BACKENDS,
                             help='compute device of the port: cuda '
                                  '(default) or cpu')
    return parser


parser = build_parser()


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
        sys.excepthook = kcli._debugger_excepthook

    if not hasattr(args, 'func'):
        parser.print_usage()
        sys.exit(kcli.ERROR_COMMAND_LINE_SWITCH)
    args.func(args)


if __name__ == '__main__':
    main(sys.argv[1:])
