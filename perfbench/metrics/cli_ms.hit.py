'''
``cli_ms.hit``: the CLI and analyser layer of a ``scan -H``, in ms (``layers.cli_ms``).
'''

from perfbench.lib.layers import cli_ms as read  # noqa: F401
