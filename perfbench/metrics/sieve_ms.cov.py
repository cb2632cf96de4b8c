'''
``sieve_ms.cov``: the sieve's thread time of a coverage scan, in ms (``layers.sieve_ms``).
'''

from perfbench.lib.layers import sieve_ms as read  # noqa: F401
