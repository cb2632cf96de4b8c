'''
The reference's matcher where the q-gram lemma's seed is short: every
ungapped alignment of every kept read against every template position,
found by brute force instead of from exact k-mer seeds.

Each read's one-hot codes are correlated with the one-hot codes of every
window of the templates laid end to end (plus and minus strands are
templates of their own, as in :py:mod:`perfbench.lib.refengine`), one
matrix product a chunk of reads: the product counts the matching bases of
each placement. A placement's mismatches are its overlap less its
matches, the overlap counting read positions below the trimmed length
and template positions inside the template; ``N`` and a read's padding
have no one-hot bit, so they never match, as ``refengine._match_chunk``
counts them. The rows are those of :py:func:`refengine.match`, in its
order: (read, template, shift, mismatches), by read, then template, then
shift. Plain ``torch``; no kernel of the program.
'''

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.lib import refengine

# reads a matrix product: the [chunk, columns] products and their masks
# take a few GB on a card, a few hundred MB on the CPU
CHUNK = {'cuda': 8192, 'cpu': 512}


class Layout:
    ''' the templates laid end to end with ``width - 1`` empty columns
        around each, so that no placement of a read of ``width`` or fewer
        bases reaches two templates; per window (column) of ``width``
        bases, its template, its shift and the overlap's bounds '''

    def __init__(self, tpl, width):
        gap = width - 1
        starts = gap + np.concatenate([[0], np.cumsum(tpl.lens + gap)])[:-1]
        codes = np.full(int(starts[-1] + tpl.lens[-1] + gap), 4, np.uint8)
        for t, (s, n) in enumerate(zip(starts, tpl.lens)):
            codes[s:s + n] = tpl.codes[tpl.base[t]:tpl.base[t] + n]
        cols = np.arange(len(codes) - width + 1)
        # column p's window starts at template t's position p - start:
        # the columns of t run from gap before its start to its last base
        self.t = np.searchsorted(starts - gap, cols, side='right') - 1
        self.d = cols - starts[self.t]
        self.codes = codes
        # overlap with a read of rl bases: min(hi, rl) - lo; hi held to
        # the width, so that every number is exact in fp16
        self.hi = np.minimum(tpl.lens[self.t] - self.d, width)
        self.lo = np.maximum(0, -self.d)


def _onehot(codes, dtype):
    ''' [..., 4 * width] from [..., width] codes (4: no bit), channel
        major as ``Tensor.unfold`` lays out a window '''
    hot = F.one_hot(codes.long(), 5)[..., :4].to(dtype)
    return hot.transpose(-1, -2).reshape(*codes.shape[:-1], -1)


def match(rec, tpl, device='cpu', chunk=None):
    ''' every alignment of every kept read within ``tpl.e`` mismatches
        that some mode of KvarQ emits, as [K, 4] (read, template, shift,
        mismatches) rows; on ``device`` in chunks of ``chunk`` reads '''
    if not len(rec.rl):
        return np.zeros((0, 4), np.int64)
    dev = torch.device(device)
    chunk = chunk or CHUNK[dev.type]
    # every product and partial sum is a count of bases, an integer of
    # at most 1,024: exact in fp16 with fp32 accumulation and in fp32.
    # TF32 and fp16 reductions are switched off all the same.
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False
    try:
        with torch.no_grad():
            return _match(rec, tpl, dev, chunk)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction) \
            = flags


def _match(rec, tpl, dev, chunk):
    dtype = torch.float16 if dev.type == 'cuda' else torch.float32
    width = int(rec.rl.max())
    lay = Layout(tpl, width)
    windows = torch.from_numpy(lay.codes).to(dev).unfold(0, width, 1)
    tmpl = _onehot(windows, dtype).T.contiguous()      # [4 * width, cols]
    hi = torch.from_numpy(lay.hi).to(dev, dtype)
    lo = torch.from_numpy(lay.lo).to(dev, dtype)
    # a placement some mode emits overlaps by this much at least
    least = min(tpl.mo, int(rec.rl.min()), int(tpl.lens.min()))
    parts = []
    for a in range(0, len(rec.rl), chunk):
        b = min(len(rec.rl), a + chunk)
        reads = _onehot(torch.from_numpy(rec.codes(a, b, width)).to(dev),
                        dtype)
        rl = torch.from_numpy(rec.rl[a:b]).to(dev, dtype)
        matches = reads @ tmpl
        overlap = torch.minimum(hi[None, :], rl[:, None]) - lo[None, :]
        ok = (overlap >= least) & (matches >= overlap - tpl.e)
        r, p = ok.nonzero(as_tuple=True)
        mism = (overlap[r, p] - matches[r, p]).long().cpu().numpy()
        r, p = r.cpu().numpy(), p.cpu().numpy()
        t, d = lay.t[p], lay.d[p]
        w = sum(m.astype(np.int64) for m in refengine.weights(
            d, rec.rl[a + r], tpl.lens[t], tpl.mo))
        keep = w > 0
        parts.append(np.stack([r[keep] + a, t[keep], d[keep], mism[keep]],
                              axis=1))
    return np.concatenate(parts).astype(np.int64)
