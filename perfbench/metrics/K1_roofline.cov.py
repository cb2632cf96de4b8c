'''
``K1_roofline.cov``: the candidate screen K1's share of its int8 roofline
in the traced samples of a coverage scan, in % (``roofline.k1_roofline``).
'''

from perfbench.lib import roofline

NAME = 'K1_roofline.cov'


def read(record):
    return roofline.k1_roofline(record, NAME)
