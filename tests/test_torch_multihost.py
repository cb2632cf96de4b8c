'''
Multi-process scale-out of the port (kvarq_tpu_torch.parallel.multihost)
and ``batch`` on the CPU: two processes in a Gloo group, each scanning its
own file shard, merge into exactly the single-process scan of the
concatenated files (mirror of tests/test_multihost.py), with global
``file_pos`` and merged reader stats; the single-process scans, the
automatic ``Lpad`` and the file assignment against kvarq_tpu's; ``batch``
(merged and ``--per-sample``) against kvarq_tpu's (mirror of
tests/test_cli.py::test_batch and ::test_batch_per_sample); and the
scale-out modules with jax absent.
'''

import json
import os
import shutil
import socket
import subprocess
import sys

import numpy as np
import pytest

from kvarq_tpu import cli as jcli
from kvarq_tpu import engine as jengine
from kvarq_tpu.log import set_warning
from kvarq_tpu.parallel import multihost as jmultihost
from kvarq_tpu_torch import cli, parallel
from kvarq_tpu_torch import engine as tengine
from kvarq_tpu_torch.parallel import multihost

from _torch_log import restore_log_levels  # noqa: F401

HERE = os.path.abspath(os.path.dirname(__file__))
ROOT = os.path.dirname(HERE)
TESTSUITES = os.path.join(ROOT, 'testsuites')
FASTQ1 = os.path.join(HERE, 'fastqs', 'L3_N1014_hits_5k.fastq')
FASTQ2 = os.path.join(HERE, 'fastqs', 'N0116_1_hits_1k.fastq')
PARAMS = dict(maxerrors=2, minoverlap=25, minreadlength=25,
              Amin=chr(33 + 13))

# one process of a two-process run, in the group named by the KVARQ_*
# environment variables; jax is made unimportable
WORKER = '''
import os, sys
sys.modules['jax'] = None
sys.modules['ml_dtypes'] = None
import numpy as np
from kvarq_tpu.engine import reader
from kvarq_tpu_torch import cli, parallel
from kvarq_tpu_torch.parallel import multihost

mode, pid, port, out = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
fastqs = sys.argv[5].split(',')
os.environ.update(KVARQ_COORDINATOR='localhost:' + port,
                  KVARQ_NUM_PROCESSES='2', KVARQ_PROCESS_ID=str(pid))
assert multihost.initialize() == (pid, 2)
# both processes share this host: each takes its half of four cards, and
# both take the one card of a one-card host
assert multihost.local_cards(4) == [[0, 1], [2, 3]][pid]
assert multihost.local_cards(1) == [0]
stats = reader.ReaderStats()
kw = dict(maxerrors=2, minoverlap=25, minreadlength=25, Amin=chr(33 + 13),
          nthreads=2, stats=stats)
res = {}
if mode == 'batch':      # both processes name the same outputs
    base = os.path.join(os.path.dirname(out), 'batch')
    for extra, dest in (([], base + '.json'), (['--per-sample'], base)):
        cli.main(['-q', '-t', 'testsuites', 'batch', '--backend', 'cpu', '-l',
                  'MTBC/phylo', *extra, *fastqs, dest])
elif mode == 'scan':
    seqs = open(sys.argv[6]).read().split()
    covs, sh, sbh = multihost.scan_sharded(
        fastqs, seqs, mesh=parallel.make_mesh(2, 2, backend='cpu'),
        b_local=256, device='cpu', **kw)
    res = dict(sh=sh, sbh=sbh, **{'c%d' % i: c for i, c in enumerate(covs)})
else:
    seqs = open(sys.argv[6]).read().split()
    hits, hitseqs = multihost.findseqs_sharded(fastqs, seqs, device='cpu',
                                               **kw)
    res = dict(hits=np.asarray([tuple(h) for h in hits], np.int64),
               hitseqs=np.asarray(hitseqs))
np.savez(out, rls=stats.rls, counts=np.asarray([
    stats.records_parsed, stats.parsed, stats.total, stats.rls_longest]),
    **res)
assert not [m for m in sys.modules if m.startswith(('jax.', 'tkinter'))]
'''


@pytest.fixture(autouse=True)
def reset_torch_engine_config():
    tengine.config(maxerrors=0, minoverlap=20, minreadlength=10,
                   nthreads=1, Amin='!', Azero='!', device='cpu', mesh='',
                   sieve=os.environ.get('KVARQ_SIEVE', 'auto'),
                   batchsize=int(os.environ.get('KVARQ_BATCHSIZE', '16384')))
    yield
    tengine.config(mesh='')


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
    ''' tests/test_multihost.py's two synthetic FastQ files and bank '''
    sys.path.insert(0, ROOT)
    import bench
    tmp = tmp_path_factory.mktemp('tmh')
    rng = np.random.RandomState(11)
    seqs = []
    for _ in range(20):
        n = rng.randint(30, 81)
        seqs.append(bytes(rng.choice(
            np.frombuffer(b'ACGT', np.uint8), n)).decode())
    f1 = str(tmp / 'part1.fastq')
    f2 = str(tmp / 'part2.fastq')
    bench.generate_fastq(f1, seqs, 3000, 71, seed=1)
    bench.generate_fastq(f2, seqs, 2600, 71, seed=2)
    spath = str(tmp / 'seqs.txt')
    with open(spath, 'w') as f:
        f.write('\n'.join(seqs))
    return f1, f2, seqs, spath, tmp


def _free_port():
    s = socket.socket()
    s.bind(('localhost', 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _two_processes(corpus, mode, fastqs=None):
    f1, f2, seqs, spath, tmp = corpus
    wpath = str(tmp / 'worker.py')
    with open(wpath, 'w') as f:
        f.write(WORKER)
    port = str(_free_port())
    outs = [str(tmp / ('%s_%d' % (mode, i))) for i in range(2)]
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen(
        [sys.executable, wpath, mode, str(i), port, outs[i],
         ','.join(fastqs or [f1, f2]), spath], cwd=ROOT,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for i in range(2)]
    try:
        logs = [p.communicate(timeout=120)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    r0, r1 = (np.load(o + '.npz') for o in outs)
    for key in r0.files:        # every process holds the merged result
        np.testing.assert_array_equal(r0[key], r1[key], err_msg=key)
    return r0, outs


def _assert_stats(r, stats):
    ''' the merged reader stats of a run equal a single scan's '''
    records, parsed, total, longest = r['counts']
    assert (records, parsed) == (stats['records_parsed'], stats['parsed'])
    assert tuple(r['rls'][:longest + 1]) == stats['readlengths']


def test_two_process_scan_matches_single(corpus):
    ''' two processes on 2x2 CPU meshes (each scans one file) merge into
        exactly kvarq_tpu's countseqs of the concatenated files '''
    f1, f2, seqs, spath, tmp = corpus
    r, _ = _two_processes(corpus, 'scan')
    jengine.config(nthreads=1, **PARAMS)
    ret = jengine.countseqs([f1, f2], seqs)
    assert list(ret['stats']['nseqhits']) == r['sh'].tolist()
    assert list(ret['stats']['nseqbasehits']) == r['sbh'].tolist()
    assert int(r['sh'].sum()) > 0
    for i, bc in enumerate(ret['basecounts']):
        np.testing.assert_array_equal(r['c%d' % i], bc)
    _assert_stats(r, ret['stats'])


def test_two_process_findseqs_matches_single(corpus):
    ''' two processes merge the hit list of kvarq_tpu's findseqs of the
        concatenated files, with globally rebased file_pos '''
    f1, f2, seqs, spath, tmp = corpus
    r, _ = _two_processes(corpus, 'findseqs')
    jengine.config(nthreads=1, mesh='', **PARAMS)
    ref = jengine.findseqs([f1, f2], seqs)
    want = np.asarray([tuple(h) for h in ref['hits']], dtype=np.int64)
    assert len(want) > 0 and want[:, 1].max() > os.path.getsize(f1)
    np.testing.assert_array_equal(r['hits'], want)
    assert list(r['hitseqs']) == ref['hitseqs']
    _assert_stats(r, ref['stats'])


def test_two_process_batch_matches_one(corpus, tmp_path):
    ''' ``batch`` as two processes: the merged json equals one process's
        batch of the same files; ``--per-sample`` splits the samples and
        process 0 summarizes both after the barrier '''
    set_warning()
    _, outs = _two_processes(corpus, 'batch', [FASTQ1, FASTQ2])
    base = os.path.join(os.path.dirname(outs[0]), 'batch')
    one = str(tmp_path / 'one.json')
    assert _main(cli.main, ['batch', '--backend', 'cpu', '-l', 'MTBC/phylo',
                            FASTQ1, FASTQ2, one]) == 0
    got, want = _json(base + '.json'), _json(one)
    for key in KEYS:
        assert got[key] == want[key], key
    assert sum(got['stats']['nseqhits']) > 0
    assert sorted(os.listdir(base)) == [
        'L3_N1014_hits_5k.json', 'N0116_1_hits_1k.json', 'summary.csv']
    with open(os.path.join(base, 'summary.csv')) as fd:
        text = fd.read()
    assert 'L3_N1014_hits_5k' in text and 'N0116_1_hits_1k' in text


def test_findseqs_sharded_single_process(corpus):
    f1, f2, seqs, spath, tmp = corpus
    jengine.config(nthreads=1, mesh='', **PARAMS)
    ref = jengine.findseqs([f1, f2], seqs)
    hits, hitseqs = multihost.findseqs_sharded(
        [f1, f2], seqs, nthreads=2, device='cpu', **PARAMS)
    assert len(ref['hits']) > 0
    assert list(hits) == list(ref['hits'])
    assert hitseqs == ref['hitseqs']


@pytest.mark.parametrize('n_data,n_bank', [(4, 2), (8, 1)])
def test_scan_sharded_single_process(corpus, n_data, n_bank):
    ''' ``scan_sharded`` in one process equals kvarq_tpu's on the same
        mesh shape (the single-process multihost test of
        tests/test_parallel.py) '''
    import jax
    if len(jax.devices()) < 8:
        pytest.skip('needs 8 (virtual) devices')
    from kvarq_tpu import parallel as jparallel
    f1, f2, seqs, spath, tmp = corpus
    want = jmultihost.scan_sharded(
        [f1], seqs, mesh=jparallel.make_mesh(n_data, n_bank), nthreads=1,
        b_local=16, **PARAMS)
    got = multihost.scan_sharded(
        [f1], seqs, mesh=parallel.make_mesh(n_data, n_bank, backend='cpu'),
        nthreads=2, b_local=16, **PARAMS)
    for w, g in zip(want[0], got[0]):
        np.testing.assert_array_equal(w.astype(np.int64), g)
    np.testing.assert_array_equal(want[1], got[1])
    np.testing.assert_array_equal(want[2], got[2])
    assert int(got[1].sum()) > 0


def test_auto_lpad_long_reads(corpus, monkeypatch):
    ''' 250 bp reads size Lpad on their own and equal the plain scan;
        KVARQ_MULTIHOST_LPAD overrides it, and a read longer than it
        raises '''
    sys.path.insert(0, ROOT)
    import bench
    f1, f2, seqs, spath, tmp = corpus
    flong = str(tmp / 'long.fastq')
    bench.generate_fastq(flong, seqs, 600, 250, seed=3)
    assert multihost.sample_max_readlen([flong, f1]) == 250
    covs, sh, sbh = multihost.scan_sharded([flong], seqs, nthreads=2,
                                           b_local=256, device='cpu',
                                           **PARAMS)
    tengine.config(nthreads=2, **PARAMS)
    ret = tengine.countseqs(flong, seqs)
    assert list(ret['stats']['nseqhits']) == sh.tolist()
    assert int(sh.sum()) > 0
    for i, bc in enumerate(ret['basecounts']):
        np.testing.assert_array_equal(bc, covs[i])

    monkeypatch.setenv('KVARQ_MULTIHOST_LPAD', '128')
    with pytest.raises(ValueError, match='exceeds Lpad=128'):
        multihost.scan_sharded([flong], seqs, nthreads=2, device='cpu',
                               **PARAMS)


def test_shard_files_match_kvarq_tpu():
    ''' the port's copy of the greedy file assignment (jax-free) gives
        kvarq_tpu's partition '''
    names = [os.path.join(HERE, 'fastqs', f) for f in (
        'test_engine.fastq', 'test_engine_1.fastq', 'test_engine_2.fastq',
        'L3_N1014_hits_5k.fastq', 'test_engine.fastq')]
    for nproc in (1, 2, 3):
        shards = [multihost.shard_file_indices(names, p, nproc)
                  for p in range(nproc)]
        assert shards == [jmultihost.shard_file_indices(names, p, nproc)
                          for p in range(nproc)]
        assert sorted(sum(shards, [])) == list(range(len(names)))
    assert multihost.initialize() == (0, 1)


@pytest.mark.parametrize('ncards', [1, 2, 3, 4, 8])
def test_host_share(ncards):
    ''' the processes of one host split its cards into balanced blocks
        that cover every card once, and share one card each when they
        outnumber the cards; a process alone keeps every card '''
    assert multihost.local_cards(ncards) == list(range(ncards))
    for m in (1, 2, 3, 4):
        shares = [multihost._host_share(k, m, ncards) for k in range(m)]
        if ncards >= m:
            assert sum(shares, []) == list(range(ncards))
            assert max(map(len, shares)) - min(map(len, shares)) <= 1
        else:
            assert all(len(s) == 1 for s in shares)
            assert sorted(set(sum(shares, []))) == list(range(ncards))


def test_runs_without_jax(corpus):
    ''' kvarq_tpu_torch.parallel and .multihost import and run with jax
        absent, and import no tkinter '''
    f1, f2, seqs, spath, tmp = corpus
    code = '''
import sys
sys.modules['jax'] = None
sys.modules['ml_dtypes'] = None
from kvarq_tpu_torch import parallel
from kvarq_tpu_torch.parallel import multihost
seqs = open(sys.argv[2]).read().split()
kw = dict(maxerrors=2, minoverlap=25, minreadlength=25, Amin=chr(33 + 13),
          nthreads=2, device='cpu')
covs, sh, sbh = multihost.scan_sharded([sys.argv[1]], seqs, **kw)
hits, _ = multihost.findseqs_sharded([sys.argv[1]], seqs, **kw)
parallel.dryrun(4, 'cpu')
assert sum(sh) > 0 and len(hits) == sum(sh)
assert not [m for m in sys.modules if m.startswith(('jax.', 'ml_dtypes.',
                                                    'tkinter'))]
'''
    proc = subprocess.run([sys.executable, '-c', code, f2, spath], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]


def _json(path):
    with open(path) as fd:
        return json.load(fd)


def _main(main, args):
    ''' run a CLI; :returns: its exit code (0 when it returns) '''
    try:
        main(['-q', '-t', TESTSUITES] + args)
    except SystemExit as e:
        return e.code
    return 0


KEYS = ('analyses', 'coverages', 'stats')


def test_cli_batch(tmp_path):
    ''' ``batch`` into one merged json equals kvarq_tpu's ``batch``; the
        same file twice doubles every count; no overwrite without -f '''
    set_warning()
    ref, one, two = (str(tmp_path / n) for n in ('ref.json', 'one.json',
                                                  'two.json'))
    port = ['batch', '--backend', 'cpu', '-l', 'MTBC/phylo']
    # kvarq_tpu with one reader thread (its threaded reader can lose the
    # wake-up at the end of input), the port with the CLI's default 8
    assert _main(jcli.main, ['batch', '-t', '1', '-l', 'MTBC/phylo', '-f',
                             FASTQ2, ref]) == 0
    assert _main(cli.main, port + ['-f', FASTQ2, one]) == 0
    r, g = _json(ref), _json(one)
    for key in KEYS:
        assert g[key] == r[key], key
    assert r['info']['config']['nthreads'] == 1
    assert g['info']['config'] == dict(r['info']['config'], nthreads=8)
    assert sum(g['stats']['nseqhits']) > 0

    assert _main(cli.main, port + ['-f', FASTQ2, FASTQ2, two]) == 0
    both = _json(two)['stats']
    for key in ('nseqhits', 'nseqbasehits'):
        assert both[key] == [2 * n for n in g['stats'][key]]
    assert both['records_parsed'] == 2 * g['stats']['records_parsed']
    assert _main(cli.main, port + [FASTQ2, one]) == jcli.ERROR_FILE_EXISTS


def test_cli_batch_per_sample(tmp_path):
    ''' ``batch --per-sample`` writes kvarq_tpu's jsons and summary.csv;
        --resume skips finished samples and redoes corrupt ones; a
        non-fastq input fails alone; same-named samples get _2 '''
    set_warning()
    dup = tmp_path / 'dup'
    dup.mkdir()
    shutil.copy(FASTQ2, dup / os.path.basename(FASTQ2))
    files = [FASTQ1, FASTQ2, str(dup / os.path.basename(FASTQ2))]
    ref, out = str(tmp_path / 'ref'), str(tmp_path / 'port')
    assert _main(jcli.main, ['batch', '-t', '1', '--per-sample', '-l',
                             'MTBC/phylo', *files, ref]) == 0
    port = ['batch', '--backend', 'cpu', '--per-sample', '-l', 'MTBC/phylo']
    assert _main(cli.main, port + files + [out]) == 0
    names = sorted(os.listdir(ref))
    assert names == sorted(os.listdir(out)) == [
        'L3_N1014_hits_5k.json', 'N0116_1_hits_1k.json',
        'N0116_1_hits_1k_2.json', 'summary.csv']
    for name in names[:-1]:
        r, g = _json(os.path.join(ref, name)), _json(os.path.join(out, name))
        for key in KEYS:
            assert g[key] == r[key], (name, key)
    with open(os.path.join(out, 'summary.csv')) as fd:
        text = fd.read()
    assert 'L3_N1014_hits_5k' in text and 'N0116_1_hits_1k' in text

    j1, j2 = (os.path.join(out, n) for n in names[:2])
    assert _main(cli.main, port + files + [out]) == jcli.ERROR_FILE_EXISTS
    before = os.path.getmtime(j2)
    with open(j1, 'w') as fd:
        fd.write('{not json')
    assert _main(cli.main, port + ['--resume'] + files + [out]) == 0
    assert os.path.getmtime(j2) == before
    assert _json(j1)['info']['format'] == 'kvarq'

    out2 = str(tmp_path / 'r2')
    assert _main(cli.main, port + [FASTQ2, 'nope.txt', out2]) \
        == jcli.ERROR_FASTQ_FORMAT_ERROR
    assert os.path.exists(os.path.join(out2, 'N0116_1_hits_1k.json'))


def test_cli_batch_per_sample_splits_listings(tmp_path, monkeypatch):
    ''' in a two-process --per-sample batch, each listing of a file goes to
        one process (kvarq_tpu assigns by name, so both of its processes
        would scan and write both listings of a file given twice) '''
    import torch.distributed
    set_warning()
    monkeypatch.setattr(torch.distributed, 'barrier', lambda: None)
    written = []
    for pid in (0, 1):
        monkeypatch.setattr(multihost, 'initialize', lambda pid=pid: (pid, 2))
        out = tmp_path / str(pid)
        assert _main(cli.main, ['batch', '--backend', 'cpu', '--per-sample',
                                '-l', 'MTBC/phylo', FASTQ2, FASTQ2,
                                str(out)]) == 0
        written.append([f for f in os.listdir(out) if f.endswith('.json')])
    assert sorted(map(len, written)) == [1, 1]
    assert sorted(sum(written, [])) == ['N0116_1_hits_1k.json',
                                        'N0116_1_hits_1k_2.json']


def test_pair_fastqs_matches_kvarq_tpu():
    ''' the port's copy of pair_fastqs (kvarq_tpu's needs tkinter) '''
    from kvarq_tpu.gui.simple import pair_fastqs
    files = ['b_1.fastq', 'a.fastq.gz', 'b_2.fastq', 'c_1.fastq',
             'd_2.fastq', 'x_1.fastq.gz', 'x_2.fastq.gz']
    assert cli.pair_fastqs(files) == pair_fastqs(files)
    assert cli.pair_fastqs(files)[1] == [False, True, False, False, True]
