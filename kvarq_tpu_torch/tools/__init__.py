'''
Tools of the port (counterparts of the repository's ``tools/``
``device_bench.py``, ``bench_scaling.py``, ``hitdiff.py`` and
``gz_bench.py``), each run as ``python -m kvarq_tpu_torch.tools.<name>``;
the device tools run on the card unless given ``--device cpu``.
'''
