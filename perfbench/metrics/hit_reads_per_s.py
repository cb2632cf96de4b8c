'''
``hit_reads_per_s``: reads a second of the ``scan -H`` scans (``layers.reads_per_s``).
'''

from perfbench.lib.layers import reads_per_s as read  # noqa: F401
