'''
Exact k-mer seed-and-verify sieve: a host-side prefilter that discards
reads which provably cannot produce any hit, before they are shipped to
the matcher.

Soundness (q-gram lemma / pigeonhole): every hit overlaps a template by at
least ``m = min(minoverlap, minreadlength, min(len(template)))`` bases with
at most ``e = maxerrors`` mismatches (see kvarq_tpu_torch.engine.hitmodel for the
per-mode overlap bounds), and the alignment is *ungapped* (workhorse.c
enumerates plain offsets, no indels).  The overlap therefore contains
``m - k + 1`` read k-mers aligned to the template on one fixed diagonal
(diagonal := template_position - read_position); each mismatch destroys at
most ``k`` of them, so at least ``t = max(1, m - k + 1 - e*k)`` read
k-mers match the template exactly *on the hit's diagonal*.

Three-stage cascade, each stage a strict superset of real hits:

1. **presence**: the read has a k-mer that occurs anywhere in the bank
   (packed-bit lookup; for 4-letter DNA and a ~40 kbp bank this alone
   passes ~10% of random reads -- too weak);
2. **seeds**: some (diagonal, template) pair collects >= t exact seeds
   (random reads pass via chance shared (k+1)-mers, a few %);
3. **verify**: for each such (diagonal, template), the actual overlap is
   checked: overlap length >= m and mismatches <= e -- the same test the
   matcher applies per shift, so stage-3 survivors are (nearly) exactly
   the hitting reads.

``N`` matches ``N`` in this engine, so k-mers are encoded base-5
(A C G T N) rather than 2-bit.  Results are bit-identical with the sieve
on or off; tests assert this, and that the native C implementation
(csrc/reader.cpp) keeps exactly the same reads as this numpy oracle.
'''

import numpy as np

from kvarq_tpu_torch.engine import encode

MIN_USEFUL_K = 6
MAX_K = 12  # 5**12 ~ 244M index entries; plenty for k>=12


class KmerSieve:

    def __init__(self, k, t, m, maxerrors, start, gpos, gtid,
                 tstart, tstop, bank_codes):
        '''
        :param k: seed length
        :param t: required number of same-(diagonal, template) seeds
        :param m: minimum possible hit overlap
        :param start: int32 [5**k + 1] -- ``gpos[start[c]:start[c+1]]`` are
            the bank positions of k-mer code ``c``
        :param gpos: int32 -- global bank positions, ascending per code
        :param gtid: int32 -- template id per ``gpos`` entry
        :param tstart/tstop: int32 [T] -- template spans in global coords
        :param bank_codes: uint8 -- concatenated template codes (junk in
            the inter-template gaps, never inside a span)
        '''
        self.k = k
        self.t = t
        self.m = m
        self.maxerrors = maxerrors
        self.start = start
        self.gpos = gpos
        self.gtid = gtid
        self.tstart = tstart
        self.tstop = tstop
        self.bank_codes = bank_codes
        self._pow = (5 ** np.arange(k - 1, -1, -1)).astype(np.int64)

    @classmethod
    def build(cls, seqs, maxerrors, minoverlap, minreadlength):
        '''
        :returns: a sieve for the template bank, or None when no useful
            ``k`` exists for the current configuration
        '''
        seqlens = [len(s) for s in seqs if len(s)]
        if not seqlens:
            return None
        m = min(minoverlap, minreadlength, min(seqlens))
        k = m // (maxerrors + 1)
        if k < MIN_USEFUL_K:
            return None
        k = min(k, MAX_K)
        t = max(1, m - k + 1 - maxerrors * k)

        # global bank layout: templates concatenated with a k-junk gap
        pow5 = (5 ** np.arange(k - 1, -1, -1)).astype(np.int64)
        codes_list, pos_list, tid_list = [], [], []
        tstart, tstop, chunks = [], [], []
        off = 0
        for tid, s in enumerate(seqs):
            codes = encode.encode_template(s)
            tstart.append(off)
            tstop.append(off + len(codes))
            chunks.append(codes)
            chunks.append(np.full(k, encode.CODE_READ_JUNK, dtype=np.uint8))
            c64 = codes.astype(np.int64)
            if len(c64) >= k:
                win = np.lib.stride_tricks.sliding_window_view(c64, k)
                valid = (win < 5).all(axis=1)
                if valid.any():
                    codes_list.append((win[valid] * pow5).sum(axis=1))
                    wpos = np.flatnonzero(valid)
                    pos_list.append(off + wpos)
                    tid_list.append(np.full(len(wpos), tid, dtype=np.int32))
            off += len(codes) + k
        if not codes_list:
            return None
        kcodes = np.concatenate(codes_list)
        gpos = np.concatenate(pos_list).astype(np.int32)
        gtid = np.concatenate(tid_list)

        order = np.argsort(kcodes, kind='stable')
        kcodes, gpos, gtid = kcodes[order], gpos[order], gtid[order]
        start = np.zeros(5 ** k + 1, dtype=np.int32)
        np.add.at(start, kcodes + 1, 1)
        start = np.cumsum(start, dtype=np.int64).astype(np.int32)
        return cls(k, t, m, maxerrors, start, gpos, gtid,
                   np.asarray(tstart, dtype=np.int32),
                   np.asarray(tstop, dtype=np.int32),
                   np.concatenate(chunks))

    def candidates(self, batch):
        '''
        :param batch: :py:class:`kvarq_tpu_torch.engine.reader.RecordBatch`
        :returns: int array of read indices that *may* hit (all others are
            provably hit-free), or None if all reads are candidates
        '''
        codes = batch.codes.astype(np.int64)
        B, L = codes.shape
        if L < self.k:
            return np.arange(B)
        win = np.lib.stride_tricks.sliding_window_view(codes, self.k, axis=1)
        valid = (win < 5).all(axis=2)
        kcodes = (win * self._pow).sum(axis=2)           # [B, W]

        b_idx, w_idx = valid.nonzero()
        kc = kcodes[b_idx, w_idx]
        s, e = self.start[kc], self.start[kc + 1]
        n = (e - s).astype(np.int64)
        keep = n > 0
        b_idx, w_idx, s, n = b_idx[keep], w_idx[keep], s[keep], n[keep]
        if not len(b_idx):
            return np.zeros(0, dtype=np.int64)

        # expand every (read, window) seed into its bank positions
        reps = np.repeat(np.arange(len(n)), n)
        flat = np.arange(len(reps)) - np.repeat(
            np.cumsum(n) - n, n)                         # intra-list index
        j = s[reps] + flat
        g = self.gpos[j].astype(np.int64)
        tid = self.gtid[j].astype(np.int64)
        b = b_idx[reps]
        diag = g - w_idx[reps]                           # bank pos - read pos

        # stage 2: >= t seeds per (read, template, diagonal)
        order = np.lexsort((diag, tid, b))
        sb, stid, sdiag = b[order], tid[order], diag[order]
        new = np.ones(len(order), dtype=bool)
        new[1:] = ((sb[1:] != sb[:-1]) | (stid[1:] != stid[:-1])
                   | (sdiag[1:] != sdiag[:-1]))
        runs = np.flatnonzero(new)
        lens = np.diff(np.append(runs, len(order)))
        hot = runs[lens >= self.t]
        if not len(hot):
            return np.zeros(0, dtype=np.int64)
        hb = sb[hot]
        htid = stid[hot]
        hdiag = sdiag[hot]

        # stage 3: exact overlap check on each hot (read, template, diag)
        rl = batch.rl.astype(np.int64)[hb]
        lo = np.maximum(self.tstart[htid].astype(np.int64), hdiag)
        hi = np.minimum(self.tstop[htid].astype(np.int64), hdiag + rl)
        ov = hi - lo
        ok = ov >= self.m
        mask = np.zeros(B, dtype=bool)
        e_max = self.maxerrors
        for i in np.flatnonzero(ok):
            bi = hb[i]
            if mask[bi]:
                continue
            g0, g1, d = int(lo[i]), int(hi[i]), int(hdiag[i])
            mism = int(np.count_nonzero(
                self.bank_codes[g0:g1]
                != batch.codes[bi, g0 - d:g1 - d]))
            if mism <= e_max:
                mask[bi] = True
        if mask.all():
            return None
        return np.flatnonzero(mask)
