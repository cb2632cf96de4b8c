'''
The ``kvarq`` command line of the port: ``python -m kvarq_tpu_torch.cli``.

The parser is kvarq_tpu's own (``kvarq_tpu.cli._COMMANDS`` /
``_GLOBAL_ARGS``) with ``scan`` rebound to :py:func:`cmd_scan`, which
runs the port's engine on a CUDA device (``--backend cuda``, the default)
or on the CPU (``--backend cpu``).  Subcommands that read result files
(``illustrate``, ``show``, ``update``, ``summarize``, ``info``,
``version``, ``explorer``) are reused as they are; those that scan
through kvarq_tpu's device engine (``batch``, ``gui``) and the
multi-device scan option ``--mesh`` are not yet ported and exit with a
message.  ``-H``/``-x`` run the hit-list scan; ``--profile`` records
phase times and a torch.profiler trace (kvarq_tpu_torch.profiling).
'''

import argparse
import sys
import time

from kvarq_tpu import cli as kcli
from kvarq_tpu.fastq import Fastq, FastqFileFormatException
from kvarq_tpu.log import (appendlog, format_traceback, lo, set_debug,
                           set_warning)
from kvarq_tpu.util import ProgressBar, get_help_path
from kvarq_tpu_torch import analyse, device, engine
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


def cmd_scan(args):
    if args.mesh:
        _refuse('scan --mesh')
    backend = args.backend or 'cuda'
    if backend not in BACKENDS:
        _refuse('--backend %s (the port runs %s)'
                % (backend, ' or '.join(BACKENDS)))
    try:
        device.select(backend)
    except RuntimeError as e:
        sys.stderr.write('\n*** %s ***\n\n' % e)
        sys.exit(kcli.ERROR_COMMAND_LINE_SWITCH)

    testsuites = kcli._selected_testsuites(args)
    if not testsuites:
        sys.stderr.write('\n*** you must specify at least one testsuite!'
                         ' ***\n\n(use the -t command line switch)\n\n')
        sys.exit(kcli.ERROR_COMMAND_LINE_SWITCH)

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

    handlers = {'scan': cmd_scan, 'batch': _not_ported('batch'),
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
            sub.add_argument(*names, **kwargs)
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
