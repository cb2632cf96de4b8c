'''
kvarq_tpu_torch -- kvarq_tpu (``kvarq scan`` and ``kvarq batch``: the
coverage path, the hit-list path and the scale-out layer; the Tk GUI; the
entry points and the measurement tools) ported to PyTorch with a
hand-written CUDA kernel for NVIDIA Hopper (sm_90a).

The package stands alone: it imports neither ``jax`` nor ``kvarq_tpu``
(nor the ``kvarq`` alias package), so a machine with a card needs only
PyTorch, numpy, g++ and the CUDA toolkit.  It keeps its own copies of the
host modules, each at the same relative path as its counterpart in
``kvarq_tpu`` (``log``, ``versions``, ``config``, ``util``, ``fastq``,
``genes``, ``legacy``, ``testsuites``, ``analyse``, ``cli``, and
``engine.encode`` / ``hitmodel`` / ``reader`` / ``sieve`` /
``match_numpy`` / ``native`` with ``csrc/reader.cpp``).  The C++ reader
is built with g++ at first use into ``build/kvarq_tpu_torch/`` at the
repository root, the CUDA kernel with nvcc into the same directory.
Testsuite plugins (``from kvarq.genes import ...``) load through
:py:func:`kvarq_tpu_torch.genes.load_testsuite`, which binds the
``kvarq`` names to this package while a plugin runs.  ``kvarq_tpu``
remains the reference that the tests (``tests/test_torch_*.py``) hold
this package against.

The device code:

- :py:mod:`kvarq_tpu_torch.device` -- explicit device selection
- :py:mod:`kvarq_tpu_torch.engine.pallas_scan` -- bank tensors, the
  candidate-screen kernel ``cand_counts`` (csrc/cand_screen.cu), the
  exact scan step and the exact hit extraction ``hit_triplets``
  (csrc/score_step.cu)
- :py:mod:`kvarq_tpu_torch.engine.tensor_scan` -- ``mode_weights`` and the
  accumulating :py:class:`TensorScanner`
- :py:mod:`kvarq_tpu_torch.engine.match_xla` /
  :py:mod:`kvarq_tpu_torch.engine.match_pallas` -- the hit-list matchers
  (exact triplet extraction; candidate screen, compaction, extraction)
- :py:mod:`kvarq_tpu_torch.engine` -- ``config`` / ``countseqs`` /
  ``findseqs``
- :py:mod:`kvarq_tpu_torch.analyse` / :py:mod:`kvarq_tpu_torch.cli` /
  :py:mod:`kvarq_tpu_torch.profiling` -- ``python -m kvarq_tpu_torch.cli
  scan [-H] [-x FILE] [--profile DIR]``
- :py:mod:`kvarq_tpu_torch.parallel` -- the mesh and multi-process scans
- :py:mod:`kvarq_tpu_torch.gui` -- the Tk GUI (``cli gui``, ``cli
  explorer``), whose scan wizard runs ``Analyser.scan`` on the engine's
  device
- :py:mod:`kvarq_tpu_torch.graft_entry` -- ``entry()`` and
  ``dryrun_multichip()``, the port's ``__graft_entry__``
- :py:mod:`kvarq_tpu_torch.tools` -- ``device_bench`` and
  ``bench_scaling``

Tests: ``python -m pytest tests/test_torch_*.py`` on the CPU (the plain
PyTorch versions, held against kvarq_tpu); on a machine with a card
``python -m pytest tests/test_torch_cuda.py -m cuda`` and
``python3 chip_smoke.py``.
'''

# the values of kvarq_tpu/__init__.py: they land in the result json
VERSION = '0.12.3'

DOWNLOAD_URL = 'https://github.com/kvarq/kvarq'
DOC_URL = 'https://kvarq.readthedocs.org/'
