'''
``emit_ms.hit``: ``_emit`` of a ``scan -H``, in ms (``layers.emit_ms``).
'''

from perfbench.lib.layers import emit_ms as read  # noqa: F401
