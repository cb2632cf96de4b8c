''' the loggers' levels put back after a test module of the port: the
    CLIs' ``-q`` and ``set_warning`` quiet the ``kvarq`` and
    ``kvarq_tpu_torch`` loggers for the whole process, and a later module
    in the same worker reads their records.  A module takes the fixture by
    importing it '''

import logging

import pytest


@pytest.fixture(scope='module', autouse=True)
def restore_log_levels():
    ''' each logger's level as the module found it, put back after it '''
    loggers = [logging.getLogger(n) for n in ('kvarq', 'kvarq_tpu_torch')]
    saved = [lg.level for lg in loggers]
    yield
    for lg, level in zip(loggers, saved):
        lg.setLevel(level)
