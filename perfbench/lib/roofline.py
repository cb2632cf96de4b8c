'''
K1's share of its roofline: the candidate screen's work, reckoned from
what the benchmark itself knows (the configuration's read length and the
plain reference's templates, never the program's padding), over the
device time of K1's kernels in the traced samples.

The screen of one read of length ``L`` against the templates laid end to
end is a one-hot product over the ``nch = 4`` base channels: ``2 * nch *
L * Q`` operations, where ``Q = sum_t (len_t + L - 1)`` counts the shifts
at which the read overlaps template ``t`` by a base or more; it reads the
read's ``L`` code bytes and its 4-byte length.  The reads screened are
the program's counter ``scan.screened``.  So the work does not change
with whatever implements the screen, and the share cannot pass 100%
while K1 is slower than its bound.
'''

from perfbench.lib import harness, spec, trace

# NVIDIA H100 SXM5 (H100 80GB HBM3): dense int8 tensor operations/s and
# HBM3 bytes/s
PEAK_OPS = 1979e12
PEAK_BYTES = 3.35e12
NCH = 4
# K1's kernels in the device trace hold this in their names
KERNEL = 'cand_screen'


def columns(read_length, lengths):
    ''' ``Q``: the shifts at which a read of ``read_length`` overlaps a
        template by a base or more, summed over templates of ``lengths`` '''
    return sum(n + read_length - 1 for n in lengths)


def screen_work(read_length, lengths):
    ''' ``(operations, bytes)`` of the screen of one read '''
    q = columns(read_length, lengths)
    return 2 * NCH * read_length * q, read_length + 4


def share(reads, kernel_us, read_length, lengths):
    ''' the screen's share of its roofline in %: ``reads`` screened in
        ``kernel_us`` microseconds of K1 '''
    ops, nbytes = screen_work(read_length, lengths)
    bound_s = max(reads * ops / PEAK_OPS, reads * nbytes / PEAK_BYTES)
    return 100.0 * bound_s / (kernel_us / 1e6)


def config_of(bench, metric):
    ''' the one configuration of the cells in ``metric``'s own
        ``workloads``; None where they name more than one (or none) '''
    entry = next((m for m in bench['per_layer'] if m['name'] == metric),
                 None)
    if entry is None or 'workloads' not in entry:
        return None
    names = {spec.cell(bench, c)['config'] for c in entry['workloads']}
    if len(names) != 1:
        return None
    return spec.config(names.pop())


def k1_roofline(record, metric, bench=None):
    ''' the share of the traced samples: the reads screened in them
        (``scan.screened``) over K1's device time in them; None without a
        trace, without K1's kernels, without the counter, or where the
        metric's cells name more than one configuration '''
    tr = record['trace']
    samples = record['program']
    if tr is None or not samples:
        return None
    if not any('scan.screened' in p['counts'] for p in samples):
        return None
    kernel_us = sum(us for name, us in
                    trace.us_by_name(tr, ('kernel',)).items()
                    if KERNEL in name)
    if not kernel_us:
        return None
    config = config_of(spec.load() if bench is None else bench, metric)
    if config is None:
        return None
    lengths = [len(s) for s in
               harness.reference_group(config, spec.ROOT).sequences()]
    reads = sum(p['counts'].get('scan.screened', 0) for p in samples)
    return share(reads, kernel_us, config['reads']['read_length'], lengths)
