'''
``read_ms.hit``: the reader's time of a ``scan -H``, in ms (``layers.read_ms``).
'''

from perfbench.lib.layers import read_ms as read  # noqa: F401
