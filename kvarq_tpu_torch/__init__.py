'''
kvarq_tpu_torch -- the ``kvarq scan`` coverage path of kvarq_tpu, ported
to PyTorch with a hand-written CUDA kernel for NVIDIA Hopper (sm_90a).

``kvarq_tpu`` stays the reference: this package imports its jax-free host
modules (FastQ reader and k-mer sieve, template bank layout, testsuites,
analysis, result format) and replaces only the device code:

- :py:mod:`kvarq_tpu_torch.device` -- explicit device selection
- :py:mod:`kvarq_tpu_torch.engine.pallas_scan` -- bank tensors, the
  candidate-screen kernel ``cand_counts`` (csrc/cand_screen.cu) and the
  exact scan step
- :py:mod:`kvarq_tpu_torch.engine.tensor_scan` -- ``mode_weights`` and the
  accumulating :py:class:`TensorScanner`
- :py:mod:`kvarq_tpu_torch.engine` -- ``config`` / ``countseqs``
- :py:mod:`kvarq_tpu_torch.analyse` / :py:mod:`kvarq_tpu_torch.cli` --
  ``python -m kvarq_tpu_torch.cli scan``

The package never imports ``jax``.
'''
