'''
``card_kernel_ms``: the card's kernel time a sample over the window, in ms
(``layers.card_kernel_ms``).
'''

from perfbench.lib.layers import card_kernel_ms as read  # noqa: F401
