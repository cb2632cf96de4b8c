'''
Device policy of the port (counterpart of kvarq_tpu/jaxutil.py).

The caller names the device; nothing here guesses one.  The JAX package's
persistent compile cache and cache-key pinning have no counterpart:
PyTorch runs eagerly, and the one CUDA kernel is built once into
``build/kvarq_tpu_torch/`` (kvarq_tpu_torch.engine.native_cuda).
'''

import torch


def select(device):
    ''' :returns: ``torch.device(device)``, after checking that it exists
        and pinning the float32 matmul precision.

        Every device quantity of a scan is an exact integer count.  TF32
        keeps 10 mantissa bits, so a float32 product that silently ran in
        TF32 could round operands or partial sums; both switches are set
        off explicitly rather than trusting the defaults (cuDNN's is on by
        default). '''
    dev = torch.device(device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('device %r requested but torch.cuda.is_available()'
                           ' is False' % str(device))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev

