'''
``inflate_ms.cov``: the decode threads' busy time of a coverage scan, in ms (``layers.inflate_ms``).
'''

from perfbench.lib.layers import inflate_ms as read  # noqa: F401
