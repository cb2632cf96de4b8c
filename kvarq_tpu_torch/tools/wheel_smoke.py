#!/usr/bin/env python
'''
Installed-use smoke of kvarq_tpu_torch: build the repository's wheel from a
copy of this checkout, install it offline into a fresh virtualenv, and run
the port from there, through its console script ``kvarq-torch`` and through
a probe that blocks ``jax``, ``kvarq_tpu`` and ``kvarq`` -- the port's
counterpart of the JAX package's tools/wheel_smoke.py.

    python -m kvarq_tpu_torch.tools.wheel_smoke [--backend cuda|cpu] [--keep]

``--backend cuda`` (the default) scans on the card: the probe builds the
kernels (K1 from csrc/cand_screen.cu, S1 and H1 from csrc/score_step.cu)
with nvcc from the installed sources into
``<site-packages>/build/kvarq_tpu_torch/`` and counts their launches over a
sieve-off scan and a hit-list scan.  ``--backend cpu`` scans on the CPU
(the kernels' plain versions; no card, no nvcc).

Steps, each of which must pass (the first failure exits 1 with its output):

1. copy the checkout (without ``COPY_IGNORE``: ``.git`` and what
   .gitignore names, such as build/ and *.egg-info) and build the wheel
   in the copy with this interpreter (``pip wheel --no-deps
   --no-build-isolation --no-index``): the build writes csrc/_reader.so,
   build/ and *.egg-info into the copy, never into the checkout;
2. a fresh venv; the wheel installed into it with ``--no-index --no-deps``;
   torch and numpy come from this interpreter's environment through a .pth
   file;
3. the probe, in the venv, from a scratch directory, with no PYTHONPATH:
   the package, its native reader and (on the card) its kernel libraries
   lie under the venv, the kernels were built there (nvcc seconds > 0), a
   sieve-off scan and a ``-H`` scan run with nothing of jax, kvarq_tpu or
   kvarq imported;
4. through ``<venv>/bin/kvarq-torch``: (a) the default scan of the MTBC
   fixture, then ``illustrate -r`` with the golden strings; (b) the same
   scan with ``KVARQ_SIEVE=off``, whose json equals (a)'s apart from its
   timing and progress; (c) ``scan -H``; the coverages, analyses and stats
   of (a) and (c), and the hits of (c), equal the checkout's own
   ``--backend cpu -H`` run;
5. csrc/_reader.so of the checkout has the sha256 it had before the run.

The last line of standard output is one JSON object: ``ok``, the wheel,
the seconds of each step, nvcc's seconds per source in the venv, the
launches the probe counted and where the reader and kernels were loaded
from.
'''

import argparse
import hashlib
import importlib.util
import json
import os
import shutil
import signal
import subprocess
import sys
import sysconfig
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FIXTURE = os.path.join(ROOT, 'tests', 'fastqs', 'L3_N1014_hits_5k.fastq')
# the tracked library that a wheel build rewrites in the tree it builds from
READER_SO = os.path.join(ROOT, 'csrc', '_reader.so')


def _ignored_names():
    ''' the name patterns of the checkout's .gitignore (entries without an
        inner ``/``) and ``.git``: what the copy of the checkout leaves out,
        its history and every build product, so the wheel holds what git
        would commit '''
    names = ['.git']
    with open(os.path.join(ROOT, '.gitignore')) as fd:
        for line in fd:
            line = line.strip().rstrip('/')
            if line and not line.startswith('#') and '/' not in line:
                names.append(line)
    return tuple(names)


COPY_IGNORE = _ignored_names()
GOLDEN = [
    'lineage 3',
    'Streptomycin resistance::SNP781687AG=rpsL.K43R',
    'Rifampicin resistance (RRDR) [761139CG=rpoB.H445D 761140AG=rpoB.H445R]',
    '703777740003771',
]
# the json keys that a scan's result is compared on
RESULT_KEYS = ('coverages', 'analyses', 'stats')
HIT_KEYS = ('hits', 'hitseqs')
SCAN = ['scan', '-f', '-l', 'MTBC']
KERNEL_SOURCES = ['cand_screen.cu', 'score_step.cu']

# run by the venv's interpreter: argv backend, fastq, output stem, the
# kernel sources (KERNEL_SOURCES; built with ``--backend cuda``).  With
# jax, kvarq_tpu and kvarq unimportable, it prints one JSON line: where the
# package, its reader and kernel libraries were loaded from, nvcc's seconds
# per source, and the launches and wall seconds of a sieve-off scan and a
# hit-list scan
PROBE = r'''
import json
import sys
import sysconfig
import time

BLOCKED = ('jax', 'kvarq_tpu', 'kvarq')
for name in BLOCKED:
    sys.modules[name] = None

import kvarq_tpu_torch
from kvarq_tpu_torch import cli, engine, util
from kvarq_tpu_torch.engine import native
from kvarq_tpu_torch.engine import pallas_scan as tps

backend, fastq, stem = sys.argv[1:4]
got = {'site': sysconfig.get_paths()['purelib'],
       'package': kvarq_tpu_torch.__file__,
       'testsuites': util.get_root_path('testsuites'),
       'reader': native.get_lib()._name if native.available() else None,
       'nvcc': {}, 'kernels': [], 'runs': {}}
if backend == 'cuda':
    from kvarq_tpu_torch.engine import native_cuda
    t = time.time()
    got['kernels'] = [lib._name for lib in native_cuda.load_all(
        sys.argv[4:])]
    got['nvcc wall'] = time.time() - t
    got['nvcc'] = dict(native_cuda.build_seconds)
for label, sieve, extra in (('sieve off', 'off', []), ('-H', 'auto', ['-H'])):
    engine.config(sieve=sieve)
    tps.cand_counts.launches = 0
    tps.score_candidates.launches = 0
    tps.hit_triplets.launches = 0
    t = time.time()
    cli.main(['-q', 'scan', '-f', '-l', 'MTBC', '--backend', backend]
             + extra + [fastq, '%s.%s.json' % (stem, sieve)])
    got['runs'][label] = {
        'seconds': time.time() - t, 'K1': tps.cand_counts.launches,
        'S1': tps.score_candidates.launches, 'H1': tps.hit_triplets.launches,
        'json': '%s.%s.json' % (stem, sieve)}
got['imported'] = sorted(m for m, mod in sys.modules.items()
                         if mod is not None and m.split('.')[0] in BLOCKED)
print(json.dumps(got))
'''


class SmokeFailure(Exception):
    pass


def check(ok, msg):
    if not ok:
        raise SmokeFailure(msg)


def sha256(path):
    ''' :returns: the file's sha256, None when it does not exist '''
    if not os.path.exists(path):
        return None
    with open(path, 'rb') as fd:
        return hashlib.sha256(fd.read()).hexdigest()


def under(path, directory):
    ''' is ``path`` inside ``directory`` (symbolic links resolved)? '''
    path, directory = os.path.realpath(path), os.path.realpath(directory)
    return path.startswith(directory + os.sep)


def copy_checkout(src, dst):
    ''' copy the checkout ``src`` to ``dst``, without COPY_IGNORE '''
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns(*COPY_IGNORE))


def shown(cmd):
    ''' ``cmd`` as one line, a script argument as ``<script>`` '''
    return ' '.join('<script>' if '\n' in a else a for a in cmd)


def start(cmd, **kw):
    ''' ``cmd`` started in a process group of its own (see :py:func:`end`) '''
    print('+ ' + shown(cmd), file=sys.stderr, flush=True)
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True, **kw)


def end(proc, timeout):
    ''' wait at most ``timeout`` seconds for ``proc``; past it, its whole
        process group (nvcc, g++ included) is killed and the smoke fails.
        A non-zero exit fails the smoke with its output.
        :returns: its standard output '''
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        raise SmokeFailure('%s ran past %d s:\n%s' % (
            shown(proc.args), timeout, err[-8000:]))
    check(proc.returncode == 0, '%s exited %d:\n%s\n%s' % (
        shown(proc.args), proc.returncode, out[-4000:], err[-8000:]))
    return out


def run(cmd, seconds=None, timeout=300, **kw):
    ''' ``cmd`` to its end (:py:func:`end`); its wall seconds go into
        ``seconds`` when given.
        :returns: its standard output '''
    t0 = time.time()
    out = end(start(cmd, **kw), timeout)
    if seconds is not None:
        seconds.append(time.time() - t0)
    return out


def bridge_paths():
    ''' the directories of this interpreter's environment that hold torch
        and numpy, for the venv's .pth file; never the checkout '''
    paths = []
    for name in ('torch', 'numpy'):
        spec = importlib.util.find_spec(name)
        check(spec is not None and spec.origin,
              '%s is not importable by %s' % (name, sys.executable))
        paths.append(os.path.dirname(os.path.dirname(spec.origin)))
    paths += [sysconfig.get_paths()[k] for k in ('purelib', 'platlib')]
    paths = list(dict.fromkeys(os.path.realpath(p) for p in paths))
    check(os.path.realpath(ROOT) not in paths, 'torch or numpy resolves to '
          'the checkout %s' % ROOT)
    return paths


def result(path, keys):
    with open(path) as fd:
        out = json.load(fd)
    return {k: out[k] for k in keys}


def without_timing(path):
    ''' the whole json of a scan less its timing and progress fields '''
    with open(path) as fd:
        out = json.load(fd)
    for key in ('scantime', 'when'):
        out['info'].pop(key)
    out['stats'].pop('progress')
    return out


def smoke(backend, tmp):
    seconds = {}
    backend_args = ['--backend', 'cpu'] if backend == 'cpu' else []
    env = {k: v for k, v in os.environ.items()
           if k != 'PYTHONPATH' and not k.startswith('KVARQ_')}

    # the checkout's own hit-list scan on the CPU, the reference of (a) and
    # (c); it runs while the wheel is built and installed
    ref_json = os.path.join(tmp, 'checkout.json')
    ref_cmd = [sys.executable, '-m', 'kvarq_tpu_torch.cli', '-q', '-t',
               os.path.join(ROOT, 'testsuites')] + SCAN + [
        '--backend', 'cpu', '-H', FIXTURE, ref_json]
    ref_proc = start(ref_cmd, cwd=ROOT, env=env)
    try:
        # 1. the wheel, built in a copy of the checkout
        t0 = time.time()
        src = os.path.join(tmp, 'src')
        copy_checkout(ROOT, src)
        dist = os.path.join(tmp, 'dist')
        run([sys.executable, '-m', 'pip', 'wheel', '--quiet', '--no-deps',
             '--no-build-isolation', '--no-index', '--no-cache-dir', '-w',
             dist, src], cwd=tmp)
        wheels = [f for f in os.listdir(dist) if f.endswith('.whl')]
        check(len(wheels) == 1, 'pip wheel made %r' % wheels)
        wheel = os.path.join(dist, wheels[0])
        seconds['wheel build'] = time.time() - t0

        # 2. a fresh venv; this interpreter's pip installs into it (the
        # venv has no pip of its own), the scripts' shebangs name the
        # venv's python
        t0 = time.time()
        venv = os.path.join(tmp, 'venv')
        run([sys.executable, '-m', 'venv', '--without-pip', venv])
        vpy = os.path.join(venv, 'bin', 'python')
        run([sys.executable, '-m', 'pip', '--python', vpy, 'install',
             '--quiet', '--no-index', '--no-deps', '--no-cache-dir', wheel])
        site = run([vpy, '-c', 'import sysconfig; '
                    'print(sysconfig.get_paths()["purelib"])']).strip()
        with open(os.path.join(site, '_kvarq_torch_deps.pth'), 'w') as fd:
            fd.write('\n'.join(bridge_paths()) + '\n')
        seconds['install'] = time.time() - t0

        # 3. the probe: jax, kvarq_tpu and kvarq blocked
        work = os.path.join(tmp, 'work')
        os.makedirs(work)
        fastq = os.path.basename(FIXTURE)
        shutil.copy(FIXTURE, work)
        t = []
        out = run([vpy, '-c', PROBE, backend, fastq, 'probe'] + KERNEL_SOURCES,
                  seconds=t, cwd=work, env=env, timeout=600)
        probe = json.loads(out.strip().splitlines()[-1])
        seconds['probe'] = t[0]
        check(under(probe['site'], venv), 'the probe ran outside the venv: '
              '%s' % probe['site'])
        for what in ('package', 'testsuites', 'reader'):
            check(probe[what] and under(probe[what], probe['site']),
                  '%s loaded from %s, not from the venv %s' % (
                      what, probe[what], probe['site']))
        check(probe['imported'] == [], 'the installed port imported %s'
              % probe['imported'])
        runs = probe['runs']
        if backend == 'cuda':
            build = os.path.join(probe['site'], 'build', 'kvarq_tpu_torch')
            check(len(probe['kernels']) == len(KERNEL_SOURCES) and all(
                under(k, build) for k in probe['kernels']),
                'kernel libraries %s not under %s' % (probe['kernels'], build))
            check(all(probe['nvcc'].get(k, 0) > 0 for k in KERNEL_SOURCES),
                  'nvcc did not build every kernel in the venv: %s'
                  % probe['nvcc'])
            check(runs['sieve off']['K1'] > 0 and runs['sieve off']['S1'] > 0,
                  'the sieve-off scan launched K1 %(K1)d and S1 %(S1)d times'
                  % runs['sieve off'])
            check(runs['-H']['K1'] > 0 and runs['-H']['H1'] > 0,
                  'the -H scan launched K1 %(K1)d and H1 %(H1)d times'
                  % runs['-H'])

        # 4. the console script from the scratch directory
        script = os.path.join(venv, 'bin', 'kvarq-torch')
        for name, extra, sieve in (('a', [], None), ('b', [], 'off'),
                                   ('c', ['-H'], None)):
            t = []
            run([script] + SCAN + backend_args + extra
                + [fastq, name + '.json'], seconds=t, cwd=work,
                env=dict(env, KVARQ_SIEVE=sieve) if sieve else env)
            seconds['scan (%s)' % name] = t[0]
        text = run([script, 'illustrate', '-r', 'a.json'], cwd=work, env=env)
        print(text)
        missing = [g for g in GOLDEN if g not in text]
        check(not missing, 'golden strings missing from illustrate: %r'
              % missing)
        a, b = (without_timing(os.path.join(work, n + '.json'))
                for n in 'ab')
        check(a == b, 'KVARQ_SIEVE=off gave another json than the default '
              'scan')
        check(without_timing(os.path.join(work, runs['sieve off']['json']))
              == a, 'the probe\'s sieve-off scan differs from (a)')
        end(ref_proc, 300)
        ref = result(ref_json, RESULT_KEYS + HIT_KEYS)
        check(result(os.path.join(work, 'a.json'), RESULT_KEYS)
              == result(ref_json, RESULT_KEYS), '(a) differs from the '
              'checkout\'s --backend cpu run')
        for path in ('c.json', runs['-H']['json']):
            check(result(os.path.join(work, path), RESULT_KEYS + HIT_KEYS)
                  == ref, '%s differs from the checkout\'s --backend cpu -H '
                  'run' % path)
        check(len(ref['hits']) > 0, 'the fixture gave no hits')
    finally:
        if ref_proc.poll() is None:
            os.killpg(ref_proc.pid, signal.SIGKILL)
            ref_proc.wait()
    return {'wheel': wheels[0], 'seconds': seconds, 'nvcc': probe['nvcc'],
            'launches': {k: {n: v[n] for n in ('K1', 'S1', 'H1')}
                         for k, v in runs.items()},
            'package': probe['package'], 'reader': probe['reader'],
            'kernels': probe['kernels'], 'imported': probe['imported'],
            'golden': GOLDEN, 'hits': len(ref['hits'])}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--backend', choices=('cuda', 'cpu'), default='cuda')
    parser.add_argument('--keep', action='store_true',
                        help='keep the temporary directory (printed)')
    args = parser.parse_args(argv)
    before = sha256(READER_SO)
    tmp = tempfile.mkdtemp(prefix='kvarq_torch_wheel_smoke_')
    try:
        got = smoke(args.backend, tmp)
        after = sha256(READER_SO)
        check(after == before, '%s changed: sha256 %s, now %s'
              % (READER_SO, before, after))
    except SmokeFailure as e:
        print('WHEEL SMOKE FAILED: %s' % e, file=sys.stderr)
        return 1
    finally:
        if args.keep:
            print('kept %s' % tmp, file=sys.stderr)
        else:
            shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps(dict(got, ok=True, backend=args.backend,
                          reader_so_sha256=after)))
    return 0


if __name__ == '__main__':
    sys.exit(main())
