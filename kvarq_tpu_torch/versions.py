'''
Minimal reimplementation of ``distutils.version.StrictVersion`` (removed in
Python 3.12) with the exact semantics the framework relies on for testsuite
and .json version gating (reference uses StrictVersion throughout, e.g.
kvarq/genes.py:670-675, kvarq/analyse.py:493-500, kvarq/testsuites.py:207-218).

Version strings have the form ``N.N[.N][aN|bN]`` -- two or three dot-separated
numbers, optionally followed by a pre-release tag ('a' or 'b' plus a number).
'''

import re


class StrictVersion:

    _re = re.compile(r'^(\d+) \. (\d+) (\. (\d+))? ([ab](\d+))?$',
                     re.VERBOSE | re.ASCII)

    def __init__(self, vstring=None):
        if vstring:
            self.parse(vstring)

    def parse(self, vstring):
        match = self._re.match(vstring)
        if not match:
            raise ValueError("invalid version number '%s'" % vstring)
        major, minor, patch, prerelease, prerelease_num = \
            match.group(1, 2, 4, 5, 6)
        if patch:
            self.version = (int(major), int(minor), int(patch))
        else:
            self.version = (int(major), int(minor), 0)
        if prerelease:
            self.prerelease = (prerelease[0], int(prerelease_num))
        else:
            self.prerelease = None

    def __str__(self):
        if self.version[2] == 0:
            vstring = '.'.join(map(str, self.version[0:2]))
        else:
            vstring = '.'.join(map(str, self.version))
        if self.prerelease:
            vstring += self.prerelease[0] + str(self.prerelease[1])
        return vstring

    def __repr__(self):
        return "StrictVersion ('%s')" % str(self)

    def _cmp(self, other):
        if isinstance(other, str):
            other = StrictVersion(other)
        elif not isinstance(other, StrictVersion):
            return NotImplemented

        if self.version < other.version:
            return -1
        if self.version > other.version:
            return 1
        # numeric versions equal -- prerelease decides:
        # no prerelease sorts *after* any prerelease
        if not self.prerelease and not other.prerelease:
            return 0
        if self.prerelease and not other.prerelease:
            return -1
        if not self.prerelease and other.prerelease:
            return 1
        if self.prerelease < other.prerelease:
            return -1
        if self.prerelease > other.prerelease:
            return 1
        return 0

    def __eq__(self, other):
        c = self._cmp(other)
        return c is not NotImplemented and c == 0

    def __lt__(self, other):
        c = self._cmp(other)
        if c is NotImplemented:
            return c
        return c < 0

    def __le__(self, other):
        c = self._cmp(other)
        if c is NotImplemented:
            return c
        return c <= 0

    def __gt__(self, other):
        c = self._cmp(other)
        if c is NotImplemented:
            return c
        return c > 0

    def __ge__(self, other):
        c = self._cmp(other)
        if c is NotImplemented:
            return c
        return c >= 0

    def __hash__(self):
        return hash((self.version, self.prerelease))
