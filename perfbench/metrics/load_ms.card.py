'''
``load_ms.card``: the testsuites' load of a coverage scan, in ms (``layers.load_ms``).
'''

from perfbench.lib.layers import load_ms as read  # noqa: F401
