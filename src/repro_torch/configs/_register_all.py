"""Import every architecture module for registry side effects.

Discovery is automatic and deterministic: every non-underscore module in
this package is imported in sorted name order, so adding a config file is
enough to make it appear in ``repro_torch.configs.list_archs()`` -- no manual
import list to forget to update (the old hand-maintained list silently
dropped newly added modules). ``base.py`` is skipped (it *defines* the
registry and registers nothing). Importing this module twice is a no-op
(Python module caching), and :func:`repro_torch.configs.base.register` still
rejects two *different* modules claiming the same name.
"""

import importlib
import pkgutil

import repro_torch.configs as _pkg

_SKIP = {"base"}

for _info in sorted(pkgutil.iter_modules(_pkg.__path__), key=lambda m: m.name):
    if _info.name in _SKIP or _info.name.startswith("_"):
        continue
    importlib.import_module(f"repro_torch.configs.{_info.name}")
