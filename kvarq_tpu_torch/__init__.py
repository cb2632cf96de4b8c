'''
kvarq_tpu_torch -- ``kvarq scan`` of kvarq_tpu (the coverage path and the
hit-list path), ported to PyTorch with a hand-written CUDA kernel for
NVIDIA Hopper (sm_90a).

``kvarq_tpu`` stays the reference: this package imports its jax-free host
modules (FastQ reader and k-mer sieve, template bank layout, testsuites,
analysis, result format) and replaces only the device code:

- :py:mod:`kvarq_tpu_torch.device` -- explicit device selection
- :py:mod:`kvarq_tpu_torch.engine.pallas_scan` -- bank tensors, the
  candidate-screen kernel ``cand_counts`` (csrc/cand_screen.cu) and the
  exact scan step
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

The package never imports ``jax``.
'''
