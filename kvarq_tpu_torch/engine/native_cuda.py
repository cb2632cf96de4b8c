'''
Build and load the port's CUDA kernels (csrc/*.cu) -- the counterpart of
kvarq_tpu/engine/native.py for the device side.

Each source is compiled on first use with ``nvcc`` into a shared library
with a plain C interface, loaded through ``ctypes`` (no PyTorch headers,
no ninja: the build takes seconds).  The library name carries the
sha256 of the source and the headers it includes, so an edited source
is never served by a stale build.  Two sources build at the same time
when two threads load them (:py:func:`load_all`).  Libraries go to
``build/kvarq_tpu_torch/`` at the repository root.
'''

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

from kvarq_tpu_torch.log import lo

HERE = os.path.abspath(os.path.dirname(__file__))
CSRC = os.path.join(os.path.dirname(HERE), 'csrc')
BUILD = os.path.join(os.path.dirname(os.path.dirname(HERE)), 'build',
                     'kvarq_tpu_torch')
ARCH = ['-gencode', 'arch=compute_90a,code=sm_90a']

_lock = threading.Lock()
_name_locks = {}
_libs = {}
# seconds spent in nvcc per source (0.0 when a current build was found)
build_seconds = {}
# nvcc's -Xptxas -v report per source (registers, shared memory, spills),
# also of a build found in place
ptxas_report = {}


def _nvcc():
    for path in (shutil.which('nvcc'), '/usr/local/cuda/bin/nvcc'):
        if path and os.path.exists(path):
            return path
    raise RuntimeError('nvcc not found: the CUDA toolkit is needed to build '
                       'the kvarq_tpu_torch kernels')


def _sources(name, seen=None):
    ''' ``name`` and the csrc/ headers it includes (``#include "x.h"``),
        recursively, in the order first met '''
    seen = [] if seen is None else seen
    seen.append(name)
    with open(os.path.join(CSRC, name)) as fd:
        for inc in re.findall(r'^\s*#\s*include\s+"([^"]+)"', fd.read(),
                              re.M):
            if inc not in seen and os.path.exists(os.path.join(CSRC, inc)):
                _sources(inc, seen)
    return seen


def src_hash(name):
    ''' sha256 of the source and of every header of csrc/ it includes, so
        an edited shared header is never served by a stale build '''
    digest = hashlib.sha256()
    for src in _sources(name):
        with open(os.path.join(CSRC, src), 'rb') as fd:
            digest.update(fd.read())
    return digest.hexdigest()[:16]


def _build(name, lib_path, digest):
    os.makedirs(BUILD, exist_ok=True)
    tmp = '%s.%d.tmp' % (lib_path, os.getpid())
    cmd = ([_nvcc()] + ARCH
           + ['-std=c++17', '-O3', '-shared', '-Xcompiler', '-fPIC',
              '-Xptxas', '-v', '-DKVQ_SRC_HASH="%s"' % digest,
              '-o', tmp, os.path.join(CSRC, name)])
    lo.info('building %s: %s' % (name, ' '.join(cmd)))
    t0 = time.time()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError('nvcc failed on %s:\n%s' % (name, proc.stderr))
    # the report first: a library that exists has its report beside it
    with open(lib_path + '.ptxas.txt', 'w') as fd:
        fd.write(proc.stderr.strip())
    os.replace(tmp, lib_path)
    build_seconds[name] = time.time() - t0
    ptxas_report[name] = proc.stderr.strip()


def load(name):
    ''' :returns: the ``ctypes.CDLL`` of ``csrc/<name>``, building it when
        no library of the current source exists '''
    with _lock:
        name_lock = _name_locks.setdefault(name, threading.Lock())
    with name_lock:
        if name in _libs:
            return _libs[name]
        digest = src_hash(name)
        lib_path = os.path.join(
            BUILD, 'lib%s-%s.so' % (os.path.splitext(name)[0], digest))
        if os.path.exists(lib_path):
            build_seconds.setdefault(name, 0.0)
            report = lib_path + '.ptxas.txt'
            if os.path.exists(report):
                with open(report) as fd:
                    ptxas_report.setdefault(name, fd.read())
        else:
            _build(name, lib_path, digest)
        lib = ctypes.CDLL(lib_path)
        lib.kvq_cuda_src_hash.restype = ctypes.c_char_p
        if lib.kvq_cuda_src_hash().decode() != digest:
            raise RuntimeError('%s was not built from the current %s'
                               % (lib_path, name))
        _libs[name] = lib
        return lib


def load_all(names):
    ''' load every source of ``names``, the builds run at the same time
        (one nvcc each) '''
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(len(names)) as pool:
        return list(pool.map(load, names))
