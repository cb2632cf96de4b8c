'''
Single source of truth for KvarQ hit semantics.

The reference C scanner (csrc/workhorse.c:1107-1174) enumerates four overlap
modes between a quality-trimmed read (length ``rl``) and a template (length
``seql``).  We re-express all four with one variable

    ``d`` = (read start) - (template start),   in template coordinates

under which the compared region is always the full intersection
``[max(0, d), min(seql, d + rl))`` of read and template, so a single
mismatch profile ``mism(d)`` (computable by one correlation on TPU) serves
all modes.  The modes then only *gate* which ``d`` yield hits:

mode A  read tail over template head  (workhorse.c:1114-1127)
        ``d = -i``, i in [max(1, rl-seql+1) .. rl-minoverlap] descending
        requires rl > minoverlap and seql > minoverlap
        hit: spos=-i length=rl-i
mode B  read head over template tail  (workhorse.c:1129-1141)
        ``d = +i``, i in [max(1, seql-rl) .. seql-minoverlap] descending
        requires rl > minoverlap and seql > minoverlap
        hit: spos=+i length=seql-i
mode C  template within read          (workhorse.c:1144-1159), only rl > seql
        ``d = -i``, i in [0 .. rl-seql] ascending
        hit: spos=-i length=seql
mode D  read within template          (workhorse.c:1160-1174), only rl <= seql
        ``d = +i``, i in [0 .. seql-rl] ascending
        hit: spos=+i length=rl

Border-case quirks replicated exactly:

- mode A stops at overlap ``seql-1`` (the ``rl-i<=seql-1`` guard,
  workhorse.c:1115-1116) so a full-template overlap is only counted by mode C;
- mode B's ``seql-i<=rl`` guard *includes* the case ``seql-i == rl`` whose
  alignment mode D also enumerates (at ``i = seql-rl``) -- the reference
  emits that hit **twice** (once per mode) whenever ``minoverlap < rl < seql``
  and the alignment matches; we reproduce the duplicate.

A hit requires mismatches(d) <= maxerrors, where mismatches are counted over
the full intersection (total budget, not consecutive -- workhorse.c:1118).
'''

import numpy as np


def modeA_range(rl, seql, mo):
    ''' (ilo, ihi) inclusive descending enumeration ihi..ilo; empty if ihi<ilo '''
    if rl > mo and seql > mo:
        return max(1, rl - seql + 1), rl - mo
    return 1, 0


def modeB_range(rl, seql, mo):
    if rl > mo and seql > mo:
        return max(1, seql - rl), seql - mo
    return 1, 0


def modeC_range(rl, seql):
    if rl > seql:
        return 0, rl - seql
    return 0, -1


def modeD_range(rl, seql):
    if rl <= seql:
        return 0, seql - rl
    return 0, -1


def d_window(rl, seql, mo):
    ''' inclusive range of ``d`` values that can possibly produce a hit '''
    dmin = 0
    dmax = 0
    alo, ahi = modeA_range(rl, seql, mo)
    if ahi >= alo:
        dmin = min(dmin, -ahi)
    blo, bhi = modeB_range(rl, seql, mo)
    if bhi >= blo:
        dmax = max(dmax, bhi)
    clo, chi = modeC_range(rl, seql)
    if chi >= clo:
        dmin = min(dmin, -chi)
    dlo, dhi = modeD_range(rl, seql)
    if dhi >= dlo:
        dmax = max(dmax, dhi)
    return dmin, dmax


def overlap(d, rl, seql):
    ''' length of the intersection of read and template at shift ``d`` '''
    return min(seql, d + rl) - max(0, d)


def clearance(Lmax, minoverlap):
    ''' minimum number of never-matching gap bases between templates in a
        concatenated bank so that the intersection window of one template
        never touches a neighboring template, for any read length <= Lmax.

        A read hitting template t starts at d >= -(Lmax-1) and ends at
        d+rl <= seql + Lmax - 1, so Lmax gap bases suffice on either side. '''
    return Lmax


def emit_hits(d_ok, rl, seql, mo):
    '''
    :param d_ok: set/dict of shifts ``d`` whose mismatch count passed
        ``<= maxerrors``
    :returns: list of ``(spos, length)`` in the reference's exact
        enumeration order (A desc, B desc, then C asc or D asc)
    '''
    out = []

    alo, ahi = modeA_range(rl, seql, mo)
    for i in range(ahi, alo - 1, -1):
        if -i in d_ok:
            out.append((-i, rl - i))

    blo, bhi = modeB_range(rl, seql, mo)
    for i in range(bhi, blo - 1, -1):
        if i in d_ok:
            out.append((i, seql - i))

    if rl > seql:
        clo, chi = modeC_range(rl, seql)
        for i in range(clo, chi + 1):
            if -i in d_ok:
                out.append((-i, seql))
    else:
        dlo, dhi = modeD_range(rl, seql)
        for i in range(dlo, dhi + 1):
            if i in d_ok:
                out.append((i, rl))

    return out


def weights_for_d(d_arr, rl, seql, mo):
    '''
    vectorized hit multiplicity per shift: how many modes emit a hit at each
    ``d`` in ``d_arr`` (0, 1 or 2 -- the mode-B/D duplicate).  Used by the
    tensorized backends.
    '''
    d = np.asarray(d_arr)
    w = np.zeros(d.shape, dtype=np.int8)

    ab_active = rl > mo and seql > mo
    if ab_active:
        alo, ahi = modeA_range(rl, seql, mo)
        w += ((-d >= alo) & (-d <= ahi)).astype(np.int8)
        blo, bhi = modeB_range(rl, seql, mo)
        w += ((d >= blo) & (d <= bhi)).astype(np.int8)
    if rl > seql:
        clo, chi = modeC_range(rl, seql)
        w += ((-d >= clo) & (-d <= chi)).astype(np.int8)
    else:
        dlo, dhi = modeD_range(rl, seql)
        w += ((d >= dlo) & (d <= dhi)).astype(np.int8)
    return w
