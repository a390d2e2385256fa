"""Multi-host orchestration.

The reference has no distributed layer; the recipe here (SURVEY.md
section 5.8) is:
- `jax.distributed.initialize()` across hosts;
- a global ('data', 'model') mesh spanning all hosts' devices, with the
  'data' axis preferentially crossing hosts (read batches are
  embarrassingly parallel) and 'model' staying within a host, whose cards
  are joined all to all (the match-slot all_gather rides the fast link);
- each host streams its own slice of the read files and feeds
  per-host global arrays via `jax.make_array_from_process_local_data`;
- count partials merge with psum inside the jitted step, so no host ever
  holds another host's reads.

Single-chip environments degrade gracefully (initialize() is skipped when
no cluster env is present).
"""

from __future__ import annotations

import os
from typing import Iterator, Optional, Tuple

import numpy as np


def initialize_cluster(coordinator: Optional[str] = None,
                       num_processes: Optional[int] = None,
                       process_id: Optional[int] = None) -> bool:
    """Initialize jax.distributed if a cluster is configured; returns
    whether multi-process mode is active."""
    import jax

    env_ok = coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS") or \
        os.environ.get("COORDINATOR_ADDRESS")
    if not env_ok:
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )
    return jax.process_count() > 1


def make_global_mesh(model: int = 1):
    """('data', 'model') mesh over all processes' devices; 'model' is kept
    within a process when it divides the local device count."""
    import jax
    from jax.sharding import Mesh

    devs = np.asarray(jax.devices())
    n = len(devs)
    if n % model != 0:
        raise ValueError(f"{n} global devices not divisible by model={model}")
    return Mesh(devs.reshape(n // model, model), ("data", "model"))


def host_shard_of_files(files, ) -> list:
    """Round-robin assignment of query files to this process."""
    import jax

    pc, pid = jax.process_count(), jax.process_index()
    return [f for i, f in enumerate(files) if i % pc == pid]


def global_batch_from_local(mesh, codes: np.ndarray, lengths: np.ndarray):
    """Assemble a global device array from this host's local read batch
    (data-sharded)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    sh_c = NamedSharding(mesh, P("data", None))
    sh_l = NamedSharding(mesh, P("data"))
    gc = jax.make_array_from_process_local_data(sh_c, codes)
    gl = jax.make_array_from_process_local_data(sh_l, lengths)
    return gc, gl
