'''
``device_idle_pct.card``: the device's idle share over traced coverage scans, in % (``layers.device_idle_pct``).
'''

from perfbench.lib.layers import device_idle_pct as read  # noqa: F401
