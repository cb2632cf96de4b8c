'''
The readings that set the limits of ``correct``, on the card at the cells'
own sizes: for one configuration and its traffics, over many seeds, the
numbers compared for the program (each seed's samples scanned once each
through ``kvarq_tpu_torch.cli.main``, as the window scans them) and for
the control (the plain reference with one mismatch fewer allowed, put in
the program's place: an approximate scan where the configuration states
an exact one).

    python3 perfbench/control.py --config mtbc_se101 --traffic cov hits \\
        --seeds 11 12 13 --control-seeds 11 12 13 [--out FILE]

Prints one JSON line a seed and a summary: for each traffic and number,
the largest the program read (the lower reading) and the smallest the
control read (the upper one).
'''

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from perfbench.lib import check, generator, harness, spec  # noqa: E402


def _sum(diffs):
    out = dict.fromkeys(check.FIELDS, 0)
    for d in diffs:
        for k, v in d.items():
            out[k] += v
    return out


def readings(config, traffics, seeds, control_seeds, card=True,
             root=ROOT):
    ''' ``{traffic: {'program': {seed: numbers}, 'control': {seed:
        numbers}}}``, each seed's numbers summed over its samples '''
    harness.program_env()
    if card:
        import torch
        if not torch.cuda.is_available():
            raise harness.Failure(3, 'no CUDA device')
    from kvarq_tpu_torch import cli
    group = harness.reference_group(config, root)
    genome = generator.genome_codes(os.path.join(root,
                                                 config['model']['genome']))
    quals = generator.quality_lines(config, root)
    errors = config['scan']['errors']
    out = {t: {'program': {}, 'control': {}} for t in traffics}
    workdir = os.path.join(tempfile.gettempdir(), 'perfbench', 'control')
    for seed in seeds:
        shutil.rmtree(workdir, ignore_errors=True)
        os.makedirs(workdir)
        t0 = time.perf_counter()
        samples = [generator.make_sample(genome, group, config, seed, k,
                                         workdir, quals=quals)[0]
                   for k in range(2)]
        t1 = time.perf_counter()
        expected = [check.Expected(p, config, group,
                                   'cuda' if card else 'cpu')
                    for p in samples]
        t2 = time.perf_counter()
        line = {'seed': seed, 'generation_s': t1 - t0, 'reference_s': t2 - t1}
        for name in traffics:
            traffic = spec.traffic(name)
            hits = traffic['path'] == 'hits'
            got, ctl = [], []
            for k, paths in enumerate(samples):
                path = os.path.join(workdir, '%s%d.json' % (name, k))
                try:
                    cli.main(harness.cli_argv(config, traffic, paths[0],
                                              path, card))
                    with open(path) as fd:
                        result = json.load(fd)
                except SystemExit:
                    result = None
                want = expected[k].result(hits)
                got.append(check.compare(result, want))
                if seed in control_seeds:
                    ctl.append(check.compare(
                        expected[k].result(hits, errors - 1), want))
            out[name]['program'][seed] = line[name] = _sum(got)
            if ctl:
                out[name]['control'][seed] = line[name + '.control'] = \
                    _sum(ctl)
        print(json.dumps(line), flush=True)
    shutil.rmtree(workdir, ignore_errors=True)
    return out


def summary(out):
    ''' per traffic and number: (lower reading, upper reading) '''
    res = {}
    for name, r in out.items():
        res[name] = {}
        for field in check.FIELDS:
            lower = max((v[field] for v in r['program'].values()),
                        default=None)
            upper = min((v[field] for v in r['control'].values()),
                        default=None)
            res[name][field] = [lower, upper]
    return res


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--config', required=True)
    p.add_argument('--traffic', nargs='+', required=True)
    p.add_argument('--seeds', nargs='+', type=int, required=True)
    p.add_argument('--control-seeds', nargs='*', type=int, default=[])
    p.add_argument('--out')
    args = p.parse_args(argv)
    out = readings(spec.config(args.config), args.traffic, args.seeds,
                   set(args.control_seeds))
    res = summary(out)
    print(json.dumps({'summary': res}), flush=True)
    if args.out:
        with open(args.out, 'w') as fd:
            json.dump({'readings': out, 'summary': res}, fd)
    return 0


if __name__ == '__main__':
    sys.exit(main())
