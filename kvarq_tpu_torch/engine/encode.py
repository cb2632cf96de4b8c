'''
Base-character encoding shared by all engine backends.

Reads may contain ``AGCTN`` (reference kvarq/fastq.py:207-209); templates may
contain arbitrary bytes (tests use ``.`` junk padding).  Codes:

====  =========  ==========================================
code  character  semantics
====  =========  ==========================================
0-3   A C G T    match iff equal
4     N          matches only ``N``
5     (read)     any other read byte -- matches nothing
6     (template) any other template byte -- matches nothing
====  =========  ==========================================

The device kernels one-hot over channels 0..4, so codes 5/6 never match
anything (including each other).  The reference C engine compares raw bytes
(csrc/workhorse.c:1118-1171), so two identical junk bytes *would* match there;
valid FastQ input contains only AGCTN reads, where behavior is identical.
The numpy golden backend compares raw bytes and is exact even for junk bytes.
'''

import numpy as np

NBASE = 5          # channels used for matching (A C G T N)
CODE_READ_JUNK = 5
CODE_TMPL_JUNK = 6

A, C, G, T, N = range(5)

_READ_LUT = np.full(256, CODE_READ_JUNK, dtype=np.uint8)
_TMPL_LUT = np.full(256, CODE_TMPL_JUNK, dtype=np.uint8)
for _i, _ch in enumerate(b'ACGTN'):
    _READ_LUT[_ch] = _i
    _TMPL_LUT[_ch] = _i

BASE_CHARS = 'ACGTN'


def encode_read(data):
    ''' encode read bytes -> uint8 codes '''
    return _READ_LUT[np.frombuffer(data, dtype=np.uint8)]


def encode_template(seq):
    ''' encode template string/bytes -> uint8 codes '''
    if isinstance(seq, str):
        seq = seq.encode('latin-1')
    return _TMPL_LUT[np.frombuffer(seq, dtype=np.uint8)]


def encode_read_array(arr):
    ''' encode a uint8 byte array (any shape) of read characters '''
    return _READ_LUT[arr]


def pad_batch(codes, rl, n, Lpad):
    ''' pad host-side batch arrays up to ``n`` rows with junk reads
        (rl=0 rows gate out of every scan path); no-op when already
        ``n`` rows '''
    pad = n - len(codes)
    if pad <= 0:
        return codes, rl.astype(np.int32, copy=False)
    codes = np.concatenate(
        [codes, np.full((pad, Lpad), CODE_READ_JUNK, dtype=np.uint8)])
    rl = np.concatenate([rl.astype(np.int32, copy=False),
                         np.zeros(pad, dtype=np.int32)])
    return codes, rl
