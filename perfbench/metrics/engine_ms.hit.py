'''
``engine_ms.hit``: the engine's time of a ``scan -H``, in ms (``layers.engine_ms``).
'''

from perfbench.lib.layers import engine_ms as read  # noqa: F401
