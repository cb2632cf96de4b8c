'''
``replay_ms.hit``: the hits' replay of a ``scan -H``, in ms (``layers.replay_ms``).
'''

from perfbench.lib.layers import replay_ms as read  # noqa: F401
