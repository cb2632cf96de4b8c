'''
``write_ms.hit``: the result's encoding and write of a ``scan -H``, in ms (``layers.write_ms``).
'''

from perfbench.lib.layers import write_ms as read  # noqa: F401
