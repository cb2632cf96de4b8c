'''
The benchmark of kvarq_tpu_torch: one run of one cell of BENCHMARK.json.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the CUDA devices the
cell asks for. It makes the cell's samples from the seed, warms up, scans
samples one after another for ``--seconds``, checks every result against
the plain reference, and prints as the last line of its standard output
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` a ``breakdown``, and last the numbers
compared with their limits (``checks``), which also end its standard
error. A run that cannot measure (no program, no device, a forbidden
module loaded) exits non-zero and prints no result.
'''

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from perfbench.lib import harness, spec  # noqa: E402


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seed', type=int, required=True)
    parser.add_argument('--seconds', type=float, required=True)
    parser.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    try:
        result = harness.execute(ROOT, spec.load(ROOT), args.workload,
                                 args.seed, args.seconds, bool(args.trace),
                                 started=STARTED)
        found = harness.forbidden_modules()
        if found:
            raise harness.Failure(4, 'forbidden modules loaded: '
                                  + ', '.join(found))
    except harness.Failure as e:
        sys.stderr.write('perfbench: %s\n' % e)
        return e.code
    sys.stdout.flush()
    for name, c in result['checks'].items():
        sys.stderr.write('check %s %s limit %s\n'
                         % (name, c['value'], c['limit']))
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
