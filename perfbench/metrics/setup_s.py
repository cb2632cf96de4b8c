'''
``setup_s``: the set-up's seconds (``layers.setup_s``).
'''

from perfbench.lib.layers import setup_s as read  # noqa: F401
