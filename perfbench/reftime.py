'''
The cost of deciding ``correct``, on a configuration's samples: the plain
reference's results (``reference_s`` in a run), and loading and comparing
a scan's result (``check_s``); or a whole run of a cell on a
configuration that no file holds yet.

    python3 perfbench/reftime.py --config mtbc_se101 --traffic cov \\
        --seed 11 [--test-panel PAIRS] [--device cpu] [--dir D] [--lib ROOT]
    python3 perfbench/reftime.py --config mtbc_pe150_gz --test-panel 500000 \\
        --seed 11 --cell mtbc_se101.hits --seconds 10

The first form makes the run's two samples from the seed in ``--dir``
(or finds them there), and times for each the reference's parse and
match (``check.Expected``), its result, and that result written as JSON,
loaded back and compared as the check compares a scan's. ``--lib ROOT``
times the reference of another checkout at ``ROOT`` on samples this one
made. ``--device cpu`` keeps the reference off the card, as on a machine
without one. The second form runs the cell (``harness.execute``) with
the configuration in place of its own; the harness prints
``reference_s`` and ``check_s``.

``--test-panel PAIRS``: the configuration's reads as PAIRS plain pairs
(or single reads) drawn from the test panel, the MTBC windows of SNPs
and regions widened by 150 bases on both sides and merged where they
meet (41 amplicons, 16,302 bases), none off target: a yardstick of the
reference on a sample whose reads nearly all hit a template.
'''

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--config', required=True)
    p.add_argument('--traffic', default='hits')
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--test-panel', type=int, metavar='PAIRS')
    p.add_argument('--device', choices=('cpu', 'cuda'))
    p.add_argument('--dir')
    p.add_argument('--lib', help='the checkout whose reference is timed')
    p.add_argument('--cell')
    p.add_argument('--seconds', type=float, default=10)
    args = p.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.lib or ROOT))
    from perfbench.lib import check, generator, harness, spec

    config = spec.config(args.config)
    group = harness.reference_group(config, ROOT)
    if args.test_panel:
        config['reads'].update(compression='none', count=args.test_panel)
        if not args.lib:
            config['reads'].update(panel=generator.panel_around(
                group.region_spans(), group.spacing + 150), off_target=0)
    if args.cell:
        result = harness.execute(ROOT, spec.load(ROOT), args.cell, args.seed,
                                 args.seconds, False, config=config,
                                 traffic=spec.traffic(args.traffic))
        print(json.dumps(result), flush=True)
        return 0 if result['correct'] else 1

    device = args.device
    if device is None:
        import torch
        device = 'cuda' if torch.cuda.is_available() else 'cpu'
    workdir = args.dir or os.path.join(tempfile.gettempdir(), 'perfbench',
                                       'reftime')
    os.makedirs(workdir, exist_ok=True)
    hits = spec.traffic(args.traffic)['path'] == 'hits'
    line = {'config': args.config, 'test_panel': args.test_panel,
            'seed': args.seed, 'device': device, 'lib': args.lib or '.'}
    samples = []
    for k in range(2):
        paths = generator.sample_paths(workdir, 's%d' % k, config['reads'])
        if not all(map(os.path.exists, paths)):
            if args.lib:
                raise SystemExit('no samples in %s: make them first '
                                 'without --lib' % workdir)
            genome = generator.genome_codes(
                os.path.join(ROOT, config['model']['genome']))
            paths, _ = generator.make_sample(genome, group, config,
                                             args.seed, k, workdir)
        samples.append(paths)
    times = {'expected_s': 0.0, 'result_s': 0.0, 'load_s': 0.0,
             'compare_s': 0.0}
    nhits = []
    for k, paths in enumerate(samples):
        t0 = time.perf_counter()
        exp = check.Expected(paths, config, group, device)
        t1 = time.perf_counter()
        want = exp.result(hits)
        t2 = time.perf_counter()
        out = os.path.join(workdir, 'result%d.json' % k)
        with open(out, 'w') as fd:
            json.dump(want, fd)
        t3 = time.perf_counter()
        with open(out) as fd:
            got = json.load(fd)
        t4 = time.perf_counter()
        diff = check.compare(got, want)
        t5 = time.perf_counter()
        assert not any(diff.values()), diff
        line.setdefault('result_bytes', []).append(os.path.getsize(out))
        os.remove(out)
        times['expected_s'] += t1 - t0
        times['result_s'] += t2 - t1
        times['load_s'] += t4 - t3
        times['compare_s'] += t5 - t4
        nhits.append(len(want.get('hits', ())) or int(
            sum(want['stats']['nseqhits'])))
        del exp, want, got
    line.update(times, reference_s=times['expected_s'] + times['result_s'],
                check_s_a_scan=(times['load_s'] + times['compare_s']) / 2,
                hits=nhits, reads=generator.reads_per_sample(config['reads']))
    print(json.dumps(line), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
