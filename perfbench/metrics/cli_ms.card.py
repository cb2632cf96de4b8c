'''
``cli_ms.card``: the CLI and analyser layer of a coverage scan, in ms (``layers.cli_ms``).
'''

from perfbench.lib.layers import cli_ms as read  # noqa: F401
