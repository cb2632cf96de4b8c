'''
Measurement tools of the port (counterparts of the repository's
``tools/device_bench.py`` and ``tools/bench_scaling.py``), each run as
``python -m kvarq_tpu_torch.tools.<name>``, on the card unless given
``--device cpu``.
'''
