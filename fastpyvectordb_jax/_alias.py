"""Keep a former import name of this package working as an alias.

``install(alias)`` makes ``import <alias>`` and ``import <alias>.<sub>``
return the ``fastpyvectordb_jax`` modules themselves, so both names share
one module object (and one class per type: isinstance checks and
pickles made under the former name keep working).
"""

from __future__ import annotations

import importlib
import importlib.abc
import importlib.util
import sys


class _AliasFinder(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    """Resolves ``<alias>.<sub>`` to the loaded ``<target>.<sub>``."""

    def __init__(self, alias: str, target: str):
        self.alias, self.target = alias, target
        self._specs = {}

    def find_spec(self, name, path=None, target=None):
        if name.startswith(self.alias + "."):
            return importlib.util.spec_from_loader(name, self)
        return None

    def create_module(self, spec):
        module = importlib.import_module(
            self.target + spec.name[len(self.alias):])
        self._specs[spec.name] = module.__spec__
        return module

    def exec_module(self, module):
        # the import system stamped the alias's spec on the module;
        # give it back its own, or its relative imports resolve oddly
        module.__spec__ = self._specs.pop(module.__spec__.name)


def install(alias: str, target: str = "fastpyvectordb_jax"):
    """Alias ``alias`` (and every submodule under it) to ``target``."""
    pkg = importlib.import_module(target)
    if not any(isinstance(f, _AliasFinder) and f.alias == alias
               for f in sys.meta_path):
        sys.meta_path.insert(0, _AliasFinder(alias, target))
    sys.modules[alias] = pkg
    return pkg
