''' random scan cases shared by the kvarq_tpu_torch tests (jax-free, so the
    CUDA tests can use it on a host without jax) '''

import numpy as np

from kvarq_tpu.engine import encode
from kvarq_tpu.engine.pallas_scan import bank_channels
from kvarq_tpu.engine.tensor_scan import build_bank

from test_pallas_scan import _random_case


def case(seed, nch, B=16, Lpad=64, nseq=7, minoverlap=25):
    ''' random reads/templates with planted hits; with ``nch`` 5 some
        template and read bases are N (the bank then needs 5 channels) '''
    rng = np.random.RandomState(seed)
    seqs, codes, rl, _ = _random_case(rng, nseq=nseq, B=B, Lpad=Lpad)
    if nch == 5:
        seqs = [s[:3] + 'N' + s[4:] if len(s) > 4 else s for s in seqs]
        real = np.arange(Lpad)[None, :] < rl[:, None]
        codes[(rng.rand(B, Lpad) < 0.05) & real] = encode.N
    bank = build_bank(seqs, Lpad, minoverlap)
    assert bank_channels(bank.codes) == nch
    return seqs, codes, rl, bank


def periodic_case(nch, B, Lpad, minoverlap=25):
    ''' a deep locus that fills whole warps of the pipeline's stages
        (csrc/kvq_s1_pipeline.h): ``B`` copies of one read of ACGT repeated
        against a template that repeats it too, so that the read matches
        whole at every fourth shift, which is one shift column residue's
        MMA columns side by side: in such a stage every read and every
        lane of a warp has passing pairs.  With ``nch`` 5 a second template
        holds an N. '''
    seqs = ['ACGT' * 60]
    if nch == 5:
        seqs.append('ACGTTGCANACGGTTACCGTA')
    readlen = min(Lpad - 4, 100)
    raw = np.full((B, Lpad), ord('A'), dtype=np.uint8)
    raw[:, :readlen] = np.frombuffer(('ACGT' * Lpad).encode()[:readlen],
                                     np.uint8)
    codes = encode.encode_read_array(raw)
    codes[:, readlen:] = encode.CODE_READ_JUNK
    rl = np.full(B, readlen, dtype=np.int32)
    bank = build_bank(seqs, Lpad, minoverlap)
    assert bank_channels(bank.codes) == nch
    return seqs, codes, rl, bank
