"""Stateful precompile registry.

Port of reference ``precompile/``, cut to its module registry
(``modules.py``, the twin of precompile/modules/registerer.go): the
chain config reads it for the active stateful precompiles and
predicaters, and ``processor.apply_upgrades`` for their activations.
The port registers no module (the reference registers its warp
precompile from the plugin VM only).
"""

from coreth_tpu_torch.precompile.modules import (  # noqa: F401
    Module,
    register_module,
    registered_modules,
    reserved_address,
)
