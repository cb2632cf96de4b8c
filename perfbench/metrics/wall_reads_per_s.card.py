'''
``wall_reads_per_s.card``: reads a second of the coverage scans over the
window, on the host's clock (``layers.reads_per_s``), where the cell's
end-to-end metric is the card's time.
'''

from perfbench.lib.layers import reads_per_s as read  # noqa: F401
