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


# complement channel permutation: A<->T, C<->G, N->N (genes.py COMPLEMENT)
COMPL_PERM = np.array([T, G, C, A, N])

# channel enumeration in sorted-character order 'ACGNT', so mutation strings
# come out pre-sorted exactly like Coverage.serialize() emits them
# (reference analyse.py:162-163 sorts the observed bases)
_SORTED_CHANNELS = sorted(range(NBASE), key=lambda c: BASE_CHARS[c])


def fold_into_coverage(cov, plus_bc, minus_bc):
    '''
    fill a :py:class:`kvarq_tpu_torch.analyse.Coverage` from tensorized base
    counts: ``plus_bc``/``minus_bc`` are [5, S] hit-overlap base counts in
    scanned-strand coordinates for the plus/minus template strands.

    Reproduces Coverage.apply_hit (reference analyse.py:57-78): minus-strand
    counts are mapped back to plus coordinates via index reversal + base
    complement; depth is the channel sum; every read base differing from the
    template base becomes a mutation entry.  Mutation strings are built in
    sorted order -- in-memory ordering differs from the (observation-ordered)
    hit path but serializes identically and all statistics
    (bases_at/fractions_at/...) are order-insensitive.
    '''
    total = np.asarray(plus_bc, dtype=np.int64).copy()
    if minus_bc is not None:
        total += np.asarray(minus_bc, dtype=np.int64)[COMPL_PERM][:, ::-1]

    depth = total.sum(axis=0)
    cov.coverage = [int(x) for x in depth]

    tmpl = encode_template(cov.plus_seq.bases)
    mutations = {}
    # mutation counts = all channels except the template's own base
    mut_total = depth - np.where(
        tmpl < NBASE,
        total[np.minimum(tmpl, NBASE - 1), np.arange(len(tmpl))], 0)
    for j in np.flatnonzero(mut_total):
        parts = []
        for c in _SORTED_CHANNELS:
            if c == tmpl[j]:
                continue
            n = int(total[c, j])
            if n:
                parts.append(BASE_CHARS[c] * n)
        mutations[int(j)] = ''.join(parts)
    cov.mutations = mutations
