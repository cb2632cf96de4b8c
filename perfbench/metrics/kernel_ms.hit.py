'''
``kernel_ms.hit``: the kernels' device time of a ``scan -H``, in ms (``layers.kernel_ms``).
'''

from perfbench.lib.layers import kernel_ms as read  # noqa: F401
