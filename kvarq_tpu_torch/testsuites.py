'''
Testsuite plugin registry.

A testsuite is a single ``.py`` file living in ``<root>/<group>/<file>.py``;
its registry name is ``group/file``.  Discovery walks a fixed, ordered set
of roots (package ``testsuites/``, ``~/kvarq_testsuites``, ``./testsuites``,
``$KVARQ_TESTSUITES`` entries, explicit ``-t`` directories) where later
roots shadow earlier ones -- same precedence as the reference
(kvarq/testsuites.py:55-96).  Actual loading happens on demand:
:py:func:`load_testsuites` resolves a user selection (names, groups, or
file paths), :py:func:`update_testsuites` resolves the name/version pairs
recorded in a result ``.json`` and enforces version compatibility.
'''

import os
import os.path
import time

from kvarq_tpu_torch import genes
from kvarq_tpu_torch.analyse import TestsuiteVersionConflictException
from kvarq_tpu_torch.log import lo
from kvarq_tpu_torch.util import get_root_path
from kvarq_tpu_torch.versions import StrictVersion


def _is_hidden(name):
    return name.startswith('_') or name.startswith('.')


def _register_root(registry, base):
    ''' add every ``<base>/<group>/<name>.py`` to the registry (shadowing
        earlier entries of the same name) '''
    if not os.path.isdir(base):
        return
    for group in sorted(os.listdir(base)):
        group_dir = os.path.join(base, group)
        if _is_hidden(group) or not os.path.isdir(group_dir):
            continue
        for fname in sorted(os.listdir(group_dir)):
            if _is_hidden(fname) or not fname.endswith('.py'):
                continue
            name = group + '/' + fname[:-len('.py')]
            path = os.path.join(group_dir, fname)
            log = lo.info if name in registry else lo.debug
            log('testsuite %s loaded from "%s"' % (name, path))
            registry[name] = path


def discover_testsuites(paths=[]):
    ''' ordered name -> path registry of all discoverable testsuites;
        ``paths`` are extra roots (from ``-t``) that shadow everything '''
    registry = {}

    package_root = os.path.abspath(get_root_path('testsuites'))
    lo.debug('discovering testsuites in root path')
    _register_root(registry, package_root)

    lo.debug('discovering testsuites in home directory')
    _register_root(registry,
                   os.path.join(os.path.expanduser('~'), 'kvarq_testsuites'))

    cwd_root = os.path.abspath('testsuites')
    if cwd_root != package_root:
        lo.debug('discovering testsuites in current working directory')
        _register_root(registry, cwd_root)

    env = os.environ.get('KVARQ_TESTSUITES')
    if env:
        lo.debug('discovering testsuites in $KVARQ_TESTSUITES')
        for base in env.split(os.path.pathsep):
            _register_root(registry, base)

    for base in paths:
        if os.path.isdir(base):
            lo.debug('discovering testsuites in "%s"' % base)
            _register_root(registry, base)
        else:
            lo.warning('could not find directory "%s"' % base)

    return registry


def _load_plugin(path):
    started = time.time()
    testsuite = genes.load_testsuite(path)
    lo.info('loaded testsuite from "%s" in %dms'
            % (path, int(1e3 * (time.time() - started))))
    return testsuite


def _name_from_path(path):
    ''' registry-style name for an explicitly given file path '''
    parts = path.split(os.path.sep)
    stem = os.path.splitext(parts[-1])[0]
    return parts[-2] + '/' + stem if len(parts) > 1 else stem


def load_testsuites(testsuite_paths, selection, raise_exception=False):
    '''
    load a user selection against a discovery registry; every item may be

    - a full testsuite name (``MTBC/phylo``),
    - a group name (``MTBC`` -- loads the whole group), or
    - the path of a testsuite ``.py`` file anywhere on disk

    loading errors are logged (or raised with ``raise_exception=True``)
    '''
    groups = {}
    for name in testsuite_paths:
        groups.setdefault(name.split('/')[0], []).append(name)

    testsuites = {}
    for item in selection:
        try:
            if item in groups:
                for name in groups[item]:
                    testsuites[name] = _load_plugin(testsuite_paths[name])
            elif item in testsuite_paths:
                testsuites[item] = _load_plugin(testsuite_paths[item])
            elif os.path.isfile(item):
                testsuites[_name_from_path(item)] = _load_plugin(item)
            else:
                lo.warning('could not find testsuite "%s"' % item)
        except genes.TestsuiteLoadingException as e:
            if raise_exception:
                raise
            lo.error('could not load testsuite from "%s" : %s' % (item, e))

    return testsuites


def _resolve(name, testsuites, testsuite_paths):
    ''' find an already-loaded testsuite or a registry path by full name,
        falling back to matching the short (post-slash) name '''
    if name in testsuites:
        return testsuites[name]
    if name in testsuite_paths:
        return _load_plugin(testsuite_paths[name])
    for fullname, path in testsuite_paths.items():
        if fullname.split('/')[-1] == name:
            lo.info('mapping testsuite "%s" to "%s"' % (name, fullname))
            return testsuites.get(fullname) or _load_plugin(path)
    return None


def _check_compatible(name, json_version, testsuite):
    ''' the loaded testsuite must be same-major and not older than what
        produced the json (reference testsuites.py:212-218) '''
    wanted = StrictVersion(json_version)
    loaded = StrictVersion(testsuite.version)
    if loaded < wanted or loaded.version[0] != wanted.version[0]:
        raise TestsuiteVersionConflictException(
            'incompatible versions testsuite "%s" : expected %s found %s'
            % (name, wanted, loaded))


def update_testsuites(testsuites, names_versions, testsuite_paths):
    ''' add the testsuites recorded in a result ``.json`` (name -> version,
        names possibly short) to ``testsuites``, enforcing version
        compatibility '''
    for name, version in names_versions.items():
        testsuite = _resolve(name, testsuites, testsuite_paths)
        if testsuite is None:
            raise genes.TestsuiteLoadingException(
                'could not find testsuite "%s"' % name)
        _check_compatible(name, version, testsuite)
        testsuites[name] = testsuite
