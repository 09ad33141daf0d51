"""Batch order and the multi-device engines: the shufflers, the role
device lists (``mesh``), arch5 and arch6 (``factored``), the balance
switcher (``switcher``) and the async trainers (``async_dp``)."""
from .mesh import RoleMesh, make_data_mesh, make_role_mesh
from .shuffler import AlignedDistShuffler, DistShuffler, EpochShuffler

# the engines load on first use, so ``import fgnn_tpu_torch.parallel`` stays
# light: {name: submodule}
_ENGINES = {
    "FactoredEngine": "factored",
    "SGNNEngine": "factored",
    "SwitcherEngine": "switcher",
    "AsyncFactoredEngine": "async_dp",
    "MultihostFactoredEngine": "factored_multihost",
}


def __getattr__(name):
    if name in _ENGINES:
        import importlib

        return getattr(importlib.import_module(f".{_ENGINES[name]}", __name__),
                       name)
    raise AttributeError(name)
