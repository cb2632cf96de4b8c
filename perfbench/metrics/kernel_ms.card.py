'''
``kernel_ms.card``: the kernels' device time of a coverage scan, in ms (``layers.kernel_ms``).
'''

from perfbench.lib.layers import kernel_ms as read  # noqa: F401
