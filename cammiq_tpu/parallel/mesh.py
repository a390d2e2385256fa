"""Device-mesh construction.

The reference is single-node shared-memory (pthreads + OpenMP,
SURVEY.md section 2); the device-mesh equivalents are:
- 'data' axis: read batches sharded data-parallel (the OpenMP
  parallel-for over reads, src/query.cpp:664, without the omp-critical
  bottleneck - counts merge via psum instead);
- 'model' axis: the flat hash index sharded (memory scaling for
  20K-genome databases), probes evaluated against local shards and match
  slots all_gathered across the shards.

The mesh is a plain reshape of the device list: the cards of one host
reach each other all to all at one rate, so only the algorithm decides
the layout.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def make_mesh(data: int = -1, model: int = 1, devices: Optional[Sequence] = None):
    """Build a ('data', 'model') Mesh.  data=-1 uses all remaining
    devices."""
    import jax
    from jax.sharding import Mesh

    devs = list(devices if devices is not None else jax.devices())
    n = len(devs)
    if data == -1:
        if n % model != 0:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model > n:
        raise ValueError(f"mesh {data}x{model} needs {data*model} devices, have {n}")
    arr = np.asarray(devs[: data * model]).reshape(data, model)
    return Mesh(arr, ("data", "model"))


def shard_map_fn(mesh, fn, in_specs, out_specs):
    """shard_map with replication checking off: the count outputs are made
    replicated by explicit psum."""
    import jax

    return jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs, check_vma=False)
