'''
``read_ms.card``: the reader's time of a coverage scan, in ms (``layers.read_ms``).
'''

from perfbench.lib.layers import read_ms as read  # noqa: F401
