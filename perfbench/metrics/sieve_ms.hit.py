'''
``sieve_ms.hit``: the sieve's thread time of a ``scan -H``, in ms (``layers.sieve_ms``).
'''

from perfbench.lib.layers import sieve_ms as read  # noqa: F401
