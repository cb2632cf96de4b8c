'''
An installed port works: ``kvarq_tpu_torch.tools.wheel_smoke --backend
cpu`` builds the repository's wheel from a copy of the checkout, installs it
offline into a fresh venv and scans the MTBC fixture there through the
``kvarq-torch`` console script and through a probe with jax, kvarq_tpu and
kvarq blocked, to the golden calls and the checkout's own results, and
leaves the checkout's tracked ``csrc/_reader.so`` as it found it.
'''

import hashlib
import json
import os
import subprocess
import sys

from kvarq_tpu_torch.tools import wheel_smoke

HERE = os.path.abspath(os.path.dirname(__file__))
ROOT = os.path.dirname(HERE)
READER_SO = os.path.join(ROOT, 'csrc', '_reader.so')


def _sha256(path):
    with open(path, 'rb') as fd:
        return hashlib.sha256(fd.read()).hexdigest()


def test_installed_wheel_scans_to_the_golden_calls():
    before = _sha256(READER_SO)
    proc = subprocess.run(
        [sys.executable, '-m', 'kvarq_tpu_torch.tools.wheel_smoke',
         '--backend', 'cpu'], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-6000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got['ok'] and got['backend'] == 'cpu'
    for call in wheel_smoke.GOLDEN:
        assert call in proc.stdout, call
    # the package and its reader came from the venv, never the checkout
    for what in ('package', 'reader'):
        assert os.sep + 'venv' + os.sep in got[what], got[what]
        assert not got[what].startswith(ROOT + os.sep), got[what]
    assert got['reader'].endswith(os.path.join(
        'site-packages', 'build', 'kvarq_tpu_torch', '_reader.so'))
    assert got['imported'] == []
    assert got['hits'] > 0
    assert _sha256(READER_SO) == before == got['reader_so_sha256']


def test_copy_leaves_out_history_and_build_products(tmp_path):
    src = tmp_path / 'src'
    kept = ['setup.py', 'csrc/reader.cpp', 'kvarq_tpu_torch/cli.py',
            'kvarq_tpu_torch/csrc/score_step.cu']
    left = ['.git/HEAD', 'build/lib/x.py', 'build/kvarq_tpu_torch/_reader.so',
            'kvarq_tpu.egg-info/PKG-INFO', 'dist/kvarq_tpu-0.whl',
            'kvarq_tpu_torch/__pycache__/cli.cpython-312.pyc']
    for rel in kept + left:
        (src / rel).parent.mkdir(parents=True, exist_ok=True)
        (src / rel).write_text(rel)
    dst = tmp_path / 'dst'
    wheel_smoke.copy_checkout(str(src), str(dst))
    copied = sorted(os.path.relpath(os.path.join(d, f), dst)
                    for d, _, files in os.walk(dst) for f in files)
    assert copied == sorted(kept)
    for rel in kept:
        assert (dst / rel).read_text() == rel
