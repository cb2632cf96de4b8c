'''
``device_idle_pct.hit``: the device's idle share over traced ``scan -H`` scans, in % (``layers.device_idle_pct``).
'''

from perfbench.lib.layers import device_idle_pct as read  # noqa: F401
