'''
A run with the timed path broken underneath comes out not correct: the
harness's look for a card skipped (the program on the CPU, at a size a
test holds), the rest of a run driven as on the card. One fault each that
a cell can have: a scan that returns its state unchanged (the previous
sample's result), half of each batch left out, and an answer altered
where it is produced. The cells run on one card, so no exchange between
cards can be left out. Besides today's cells, ``mtbc_se101`` at four
mismatches (``-e 4``: a seed of 5 bases, no sieve, the brute-force
reference), the deployment a later cell scans.
'''

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from perfbench.lib import harness, spec

ROOT = spec.ROOT
BENCH = spec.load()


def run(cell, tmp_path, monkeypatch, count=20000, errors=None):
    monkeypatch.setenv('TMPDIR', str(tmp_path))
    monkeypatch.setattr('tempfile.tempdir', None)
    config = spec.config(spec.cell(BENCH, cell)['config'])
    config['reads']['count'] = count
    if errors is not None:
        # the CPU program screens every read without the sieve: fewer
        config['scan']['errors'] = errors
        config['reads']['count'] = count // 2
    return harness.execute(ROOT, BENCH, cell, 2 ** 31 + 11, 0.1, False,
                           card=False, config=config)


def stale(monkeypatch):
    from kvarq_tpu_torch import engine
    for name in ('countseqs', 'findseqs'):
        real = getattr(engine, name)
        first = []

        def once(fname, seqs, real=real, first=first):
            if not first:
                first.append(real(fname, seqs))
            return first[0]
        monkeypatch.setattr(engine, name, once)


def half_batches(monkeypatch):
    from kvarq_tpu_torch import engine
    from kvarq_tpu_torch.engine.reader import RecordBatch
    real = engine._batches

    def halves(fnames, sieve):
        for b in real(fnames, sieve):
            n = (len(b) + 1) // 2
            yield RecordBatch(b.codes[:n], b.rl[:n], b.filepos[:n],
                              b.raw[:n])
    monkeypatch.setattr(engine, '_batches', halves)


def altered(monkeypatch):
    from kvarq_tpu_torch import engine
    real_count, real_find = engine.countseqs, engine.findseqs

    def count(fname, seqs):
        ret = real_count(fname, seqs)
        ret['basecounts'][0] = np.asarray(ret['basecounts'][0]).copy()
        ret['basecounts'][0][0, 30] += 1
        return ret

    def find(fname, seqs):
        ret = real_find(fname, seqs)
        s = ret['hitseqs'][0]
        ret['hitseqs'][0] = ('C' if s[0] != 'C' else 'G') + s[1:]
        return ret
    monkeypatch.setattr(engine, 'countseqs', count)
    monkeypatch.setattr(engine, 'findseqs', find)


CELLS = [w['name'] for w in BENCH['workloads']
         if w['config'] == 'mtbc_se101']
# (cell, maxerrors of the scan: the configuration's where None)
CASES = [pytest.param(c, None, id=c) for c in CELLS] + [
    pytest.param('mtbc_se101.cov', 4, id='mtbc_se101.cov-e4')]


@pytest.mark.parametrize('cell,errors', CASES)
def test_sound_run_is_correct(cell, errors, tmp_path, monkeypatch):
    result = run(cell, tmp_path, monkeypatch, errors=errors)
    assert result['correct'], result['checks']
    # one warm-up scan, then every sample at least once in the window
    samples = spec.traffic(spec.cell(BENCH, cell)['traffic'])['samples']
    assert result['failed'] == 0 and result['attempted'] >= 1 + samples
    assert list(result)[-1] == 'checks'
    assert all(c['limit'] == 0 for c in result['checks'].values())


@pytest.mark.parametrize('fault', [stale, half_batches, altered],
                         ids=['state-unchanged', 'half-batch', 'altered'])
@pytest.mark.parametrize('cell,errors', CASES)
def test_broken_path_is_not_correct(cell, errors, fault, tmp_path,
                                    monkeypatch):
    fault(monkeypatch)
    result = run(cell, tmp_path, monkeypatch, errors=errors)
    assert not result['correct']
    assert result['failed'] > 0
    assert any(c['value'] > c['limit'] for c in result['checks'].values())


def test_paired_gzip_cell_is_correct_on_the_cpu(tmp_path, monkeypatch):
    result = run('mtbc_pe150_gz.cov', tmp_path, monkeypatch, count=6000)
    assert result['correct'], result['checks']


def test_runner_without_the_program_prints_no_result(tmp_path):
    ''' a directory with only BENCHMARK.json and the benchmark's files '''
    import shutil
    shutil.copy(os.path.join(ROOT, 'BENCHMARK.json'), tmp_path)
    shutil.copytree(os.path.join(ROOT, 'perfbench'), tmp_path / 'perfbench',
                    ignore=shutil.ignore_patterns('__pycache__'))
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    proc = subprocess.run(
        [sys.executable, 'perfbench/run.py', '--workload', CELLS[0],
         '--seed', '1', '--seconds', '1', '--trace', '0'],
        cwd=tmp_path, capture_output=True, text=True, timeout=120, env=env)
    assert proc.returncode != 0
    assert not proc.stdout.strip()


@pytest.mark.cuda
def test_a_short_run_on_the_card_is_correct():
    torch = pytest.importorskip('torch')
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    proc = subprocess.run(
        [sys.executable, 'perfbench/run.py', '--workload', CELLS[0],
         '--seed', str(2 ** 31 + 5), '--seconds', '2', '--trace', '1'],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result['correct'] and result['device']['platform'] == 'gpu'
