"""Sharding rules and the SPMD runtime on a ``DeviceMesh`` (the port of
``repro/sharding/``). Importing this package loads no torch: ``mesh`` and
``rules`` are plain Python, and ``spmd`` is imported where it is used."""
from repro_torch.sharding.mesh import AbstractMesh, make_abstract_mesh
from repro_torch.sharding.rules import (AxisRules, batch_specs,
                                        current_rules, decode_state_specs,
                                        logical_to_spec, param_specs,
                                        set_rules)
