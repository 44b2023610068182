"""Multi-host initialization helpers.

On a multi-host cluster each host runs the same program;
``init_multi_host`` wires up ``jax.distributed`` so ``jax.devices()`` is the
global device list, then the mesh/sharding layer (parallel/mesh.py)
expresses everything in global terms and XLA routes the collectives. (The reference is single-device and has no equivalent; SURVEY.md
section 2c.)

Typical multi-host entry::

    from madrona_learn_tpu.parallel import distributed, make_mesh
    distributed.init_multi_host()               # no-op on single host
    mesh = make_mesh(MeshConfig(data=16, policy=2))
    ...
    mgr = shard_training_manager(init_training(...), mesh)

Checkpointing on multi-host uses orbax's multihost-aware async save (every
host writes its shard); restore with the same mesh.
"""

from __future__ import annotations

import os
from typing import Optional

import jax


def init_multi_host(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Initialize jax.distributed when running under a multi-host launcher.

    Returns True if distributed mode was initialized. With no arguments and
    ``JAX_COORDINATOR_ADDRESS`` in the environment, this is a no-op so
    single-host runs work unchanged.
    """
    env_coord = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if coordinator_address is None and not env_coord:
        return False

    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return True


def is_primary_host() -> bool:
    return jax.process_index() == 0
