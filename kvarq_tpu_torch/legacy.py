'''
Upgrades for result ``.json`` files written by historic KvarQ versions, so
``kvarq update``/``illustrate``/the explorer can still open them.  Each
supported on-disk version gets one in-place upgrade step; steps are chained
until the current format is reached (semantics per reference
kvarq/legacy.py: v0.10 stored coverages keyed by *test* under
``testsuites``/``tests``, v0.11 had scalar ``info.fastq``/``info.size``).
'''

from collections import OrderedDict

from kvarq_tpu_torch import VERSION
from kvarq_tpu_torch.log import lo
from kvarq_tpu_torch.versions import StrictVersion


def _exceptions():
    # imported lazily: analyse itself imports this module
    from kvarq_tpu_torch.analyse import (VersionConflictException,
                                   DataInconcistencyException)
    return VersionConflictException, DataInconcistencyException


def _upgrade_v0_10(testsuites, data):
    ''' re-key per-test coverages by template identifier, dropping
        duplicates (tests sharing a template) and remapping the
        per-sequence stat arrays accordingly '''
    _, DataInconcistencyException = _exceptions()

    template_of = {str(test): test.template
                   for testsuite in testsuites.values()
                   for test in testsuite.tests}
    old_coverages = {testname: serialized
                     for block in data['testsuites'].values()
                     for testname, serialized in block.items()}

    coverages = OrderedDict()
    kept_indices = []
    for i, testname in enumerate(data['tests']):
        if testname not in template_of:
            lo.info('json contains additional test "%s"; discarding.'
                    % testname)
            continue
        key = str(template_of[testname])
        serialized = old_coverages[testname]
        if key in coverages:
            if coverages[key] != serialized:
                raise DataInconcistencyException(
                    'found contradicting coverages for template "%s" : '
                    '"%s" / "%s"' % (key, coverages[key], serialized))
        else:
            coverages[key] = serialized
            kept_indices.append(i)

    data['coverages'] = list(coverages.items())
    lo.debug('mapping "nseqhits", "nseqbasehits" : (%d) %s'
             % (len(kept_indices), str(kept_indices)))

    # stat arrays were [forward tests..., reverse tests...]; keep the same
    # layout over the deduplicated coverage list
    n_tests = len(data['tests'])
    for key in ('nseqhits', 'nseqbasehits'):
        if key not in data['stats']:
            lo.info('no stats/%s found (old json version)' % key)
            continue
        values = data['stats'][key]
        data['stats'][key] = ([values[i] for i in kept_indices]
                              + [values[i + n_tests] for i in kept_indices])

    del data['testsuites']
    del data['tests']


def _upgrade_v0_11(testsuites, data):
    ''' single fastq file -> list-valued ``info.fastq``/``info.size`` '''
    data['info']['fastq'] = [data['info']['fastq']]
    data['info']['size'] = [data['info']['size']]


#: (major, minor) -> in-place upgrade to (major, minor+1)
_UPGRADES = {
    (0, 10): _upgrade_v0_10,
    (0, 11): _upgrade_v0_11,
}


def convert_legacy_data(testsuites, data):
    '''
    :param testsuites: dict of loaded :py:class:`kvarq_tpu_torch.genes.Testsuite`
        (needed to resolve v0.10 test names to templates)
    :param data: decoded result ``.json`` dict, possibly in an old format
    :returns: ``data``, upgraded in place to the current format

    raises ``VersionConflictException`` when no upgrade path exists and
    ``DataInconcistencyException`` on contradictory legacy data.
    '''
    VersionConflictException, _ = _exceptions()

    target = tuple(StrictVersion(VERSION).version[:2])
    found = tuple(StrictVersion(data['info']['version']).version[:2])

    if found[1] < 10:
        raise VersionConflictException('cannot load files v<0.10')

    while found != target:
        upgrade = _UPGRADES.get(found)
        if upgrade is None:
            raise VersionConflictException(
                'could not elevate version more than to "%d.%d"' % found)
        upgrade(testsuites, data)
        found = (found[0], found[1] + 1)

    return data
