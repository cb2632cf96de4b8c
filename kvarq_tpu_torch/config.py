'''
Scan parameter defaults, declared once and projected into the two shapes
the rest of the code wants: the user-facing ``default_config`` dict (same
keys/values as reference kvarq/config.py, also edited by the GUI settings
dialog) and the ``engine.config()`` kwargs via :py:func:`config_params`.

Engine knobs beyond the reference (compute ``backend``, k-mer ``sieve``)
are configured through ``engine.config`` / ``KVARQ_*`` env vars directly,
not here.
'''

# (user-facing name, default, engine kwarg or None)
_PARAMS = (
    ('quality', 13, None),            # mapped to Amin via the fastq's dQ
    ('errors', 2, 'maxerrors'),
    ('minimum overlap', 25, 'minoverlap'),
    ('minimum readlength', 25, 'minreadlength'),
    ('threads', 8, 'nthreads'),
    ('spacing', 25, None),            # consumed by the Analyser, not engine
)

default_config = {name: value for name, value, _ in _PARAMS}


def config_params(config, fastq):
    ''' engine.config() kwargs for a ``default_config``-style dict; needs
        the :py:class:`kvarq_tpu_torch.fastq.Fastq` for its PHRED offset '''
    kwargs = {kwarg: config[name]
              for name, _, kwarg in _PARAMS if kwarg is not None}
    kwargs['Amin'] = fastq.Q2A(config['quality'])
    kwargs['Azero'] = fastq.Azero
    return kwargs
