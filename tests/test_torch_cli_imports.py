'''
The port's command line imports torch only where it needs a device, as
kvarq_tpu's imports jax: with ``torch`` blocked in ``sys.modules``, ``scan
--backend numpy`` gives the golden calls on the MTBC fixture, ``illustrate``
prints them and ``--help`` runs, while a default scan fails before
scanning and names the card.
'''

import json
import os
import subprocess
import sys

import pytest

HERE = os.path.abspath(os.path.dirname(__file__))
ROOT = os.path.dirname(HERE)
TESTSUITES = os.path.join(ROOT, 'testsuites')
FASTQ1 = os.path.join(HERE, 'fastqs', 'L3_N1014_hits_5k.fastq')

needs_genome = pytest.mark.skipif(
    not os.path.exists(os.path.join(TESTSUITES, 'MTBC',
                                    'MTB_ancestor_reference.bases')),
    reason='run tools/reconstruct_genome.py first')

# runs cli.main(argv) with torch unimportable; the last line of its output
# is the exit code and whether any module got hold of torch
NO_TORCH = r'''
import json, sys
sys.modules['torch'] = None
from kvarq_tpu_torch import cli
code = 0
try:
    cli.main(sys.argv[1:])
except SystemExit as e:
    code = e.code or 0
sys.stdout.flush()
print(json.dumps({'code': code, 'torch': sys.modules['torch'] is not None}))
'''

GOLDEN = ['Streptomycin resistance::SNP781687AG=rpsL.K43R',
          'Ethambutol resistance::SNP4247431GT=embB.M306I',
          'Isoniazid resistance [2155168CG=katG.S315T]',
          'Rifampicin resistance (RRDR) '
          '[761139CG=rpoB.H445D 761140AG=rpoB.H445R]',
          'remark: low coverage (RRDR below 10x)',
          'lineage 3']


def _run(*argv):
    ''' :returns: ``(code, stdout, stderr)`` of the CLI run with torch
        blocked '''
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, '-c', NO_TORCH] + list(argv),
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = proc.stdout.rstrip('\n').split('\n')
    last = json.loads(lines[-1])
    assert not last['torch']
    return last['code'], '\n'.join(lines[:-1]), proc.stderr


@needs_genome
def test_numpy_scan_and_illustrate_without_torch(tmp_path):
    out = str(tmp_path / 'out.json')
    code, _, err = _run('-t', TESTSUITES, 'scan', '-f', '-l', 'MTBC',
                        '--backend', 'numpy', '--variant', 'Illumina 1.8+',
                        FASTQ1, out)
    assert code == 0, err[-4000:]
    with open(out) as fd:
        assert fd.read().strip()
    code, text, err = _run('-t', TESTSUITES, 'illustrate', '-r', out)
    assert code == 0, err[-4000:]
    for call in GOLDEN:
        assert call in text, call


def test_help_without_torch():
    code, text, _ = _run('--help')
    assert code == 0
    assert 'scan' in text and 'illustrate' in text


@pytest.mark.parametrize('backend', [[], ['--backend', 'cuda'],
                                     ['--backend', 'auto']])
def test_device_scan_without_torch_names_the_card(backend, tmp_path):
    ''' the default scan, and auto (whose device path is the card), exit
        with the command-line error before scanning, naming the backend
        and torch '''
    out = tmp_path / 'out.json'
    code, _, err = _run('-t', TESTSUITES, 'scan', '-f', '-l', 'MTBC',
                        *backend, FASTQ1, str(out))
    assert code != 0
    assert '--backend %s needs torch' % (backend[1:] or ['cuda'])[0] in err
    assert not out.exists()


def test_importing_the_cli_leaves_torch_unloaded():
    ''' with torch installed, importing the CLI imports neither torch nor
        the modules that need it '''
    code = ('import sys; import kvarq_tpu_torch.cli; print(sorted(m for m '
            'in sys.modules if m.split(".")[0] == "torch" or m in ('
            '"kvarq_tpu_torch.device", "kvarq_tpu_torch.parallel", '
            '"kvarq_tpu_torch.engine.tensor_scan")))')
    proc = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=ROOT),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip() == '[]'
