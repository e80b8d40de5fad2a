"""Former name of the ``sctagger`` package, kept so that existing imports
and ``python -m`` invocations under it go on working.

Importing this name, or any module below it, returns the module of the same
path under ``sctagger`` (the one module object, never a second copy).
``python -m`` with this name runs ``sctagger/__main__.py``.
"""

import importlib
import importlib.abc
import importlib.util
import sys

import sctagger as _target

_OLD = __name__
_NEW = _target.__name__


class _AliasFinder(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    def find_spec(self, name, path=None, target=None):
        # __main__ is left to the path finder, which finds sctagger's own
        # file through the package path below (runpy needs its code object)
        if name.startswith(_OLD + ".") and name != _OLD + ".__main__":
            return importlib.util.spec_from_loader(name, self)
        return None

    def create_module(self, spec):
        return importlib.import_module(_NEW + spec.name[len(_OLD):])

    def exec_module(self, module):
        pass


sys.meta_path.insert(0, _AliasFinder())
sys.modules[_OLD] = _target
