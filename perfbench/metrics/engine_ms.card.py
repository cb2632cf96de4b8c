'''
``engine_ms.card``: the engine's time of a coverage scan, in ms (``layers.engine_ms``).
'''

from perfbench.lib.layers import engine_ms as read  # noqa: F401
