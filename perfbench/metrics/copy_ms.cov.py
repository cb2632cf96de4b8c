'''
``copy_ms.cov``: the host-to-device copies of the reads' codes and
lengths a traced sample of a coverage scan, in ms (span ``engine.copy``).
'''

from perfbench.lib import program


def read(record):
    return program.span_ms(record['program'], ('engine.copy',))
