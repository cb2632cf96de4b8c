'''
``load_ms.hit``: the testsuites' load of a ``scan -H``, in ms (``layers.load_ms``).
'''

from perfbench.lib.layers import load_ms as read  # noqa: F401
