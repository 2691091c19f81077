"""The party mesh: the ceremony's parties sharded over ranks of
``torch.distributed`` (``mesh``), the one-host launcher (``hostmesh``),
joining hosts (``multihost``) and the sign lane's device map
(``signmesh``).  Counterpart of ``dkg_tpu/parallel``."""

import importlib

_SUBMODULES = ("hostmesh", "mesh", "multihost", "signmesh")


def __getattr__(name):
    if name in _SUBMODULES:
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_SUBMODULES))
