"""Multi-host scale-out helpers.

The reference is single-host only (`jax.pmap` over local devices; no
`jax.distributed`, SURVEY.md §2.4). On one host, one process drives every
local GPU through the ('ens', 'data') mesh and needs nothing from this
module. Multi-host runs use the standard JAX distributed runtime plus the
same mesh, laid out so:

- the ensemble axis spans hosts (members are independent — zero
  cross-host traffic during training);
- the data axis stays within each host (its loss all-reduce runs over the
  host's NVLink and never crosses the network).

Typical multi-host usage (same script on every host, one process each):

    from bayesnf_tpu.parallel import distributed
    distributed.initialize('host0:1234', num_processes=2, process_id=rank)
    mesh = distributed.multihost_mesh(data_devices_per_host=1)
    model.fit(df, seed, ensemble_size=256, mesh=mesh)

Every host must run the same fit with the same arguments (standard SPMD).
The trainers detect a multi-process mesh, shard their (identical per-host)
inputs onto it with `make_global`, and gather final params/losses with
`host_value`, so params_/losses_ come back as full host values on every
host. Validated end-to-end by `tests/test_multiprocess.py` (two real
processes over Gloo CPU collectives).
"""

import numpy as np

import jax
from jax.sharding import Mesh

from bayesnf_tpu.parallel import mesh as mesh_lib


def initialize(coordinator_address=None, num_processes=None, process_id=None):
  """Initialize the JAX distributed runtime (no-op if already initialized).

  Pass the coordinator address, the process count and this process's id
  explicitly (see `jax.distributed.initialize`); a plain GPU host has no
  cluster environment to discover them from.
  """
  if getattr(jax.distributed, 'is_initialized', lambda: False)():
    return
  try:
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
  except RuntimeError as e:
    # Double-init raises RuntimeError('distributed.initialize should only
    # be called once.') — treat it (and older phrasings) as the no-op.
    msg = str(e)
    if 'once' not in msg and 'already initialized' not in msg:
      raise


def multihost_mesh(data_devices_per_host: int = 1) -> Mesh:
  """('ens', 'data') mesh over all hosts' devices.

  Devices are arranged host-major on the ensemble axis so that each host's
  local devices form contiguous ensemble groups, and the data axis (if > 1)
  is built from devices of the same host.
  """
  devices = np.asarray(jax.devices())
  num_local = jax.local_device_count()
  if num_local % data_devices_per_host != 0:
    raise ValueError(
        f'{data_devices_per_host=} must divide local device count'
        f' {num_local}.'
    )
  grid = devices.reshape(-1, data_devices_per_host)
  return Mesh(grid, (mesh_lib.ENSEMBLE_AXIS, mesh_lib.DATA_AXIS))


def is_multiprocess_mesh(mesh: Mesh) -> bool:
  """True when the mesh spans devices of more than one process."""
  procs = {d.process_index for d in mesh.devices.flat}
  return len(procs) > 1


def make_global(x, sharding):
  """Host-replicated value -> global `jax.Array` with the given sharding.

  Standard SPMD setup: every process holds the SAME full `x` (same script,
  same seed) and contributes its local shards. Required on multi-process
  meshes, where a plain jit call cannot auto-shard process-local inputs.
  """
  host = np.asarray(x)
  return jax.make_array_from_callback(
      host.shape, sharding, lambda idx: host[idx]
  )


def host_value(x):
  """Global `jax.Array` -> full host numpy value on EVERY process.

  np.asarray works for single-process and fully-replicated arrays; arrays
  sharded across processes are gathered with an explicit cross-process
  allgather first.
  """
  if (
      not isinstance(x, jax.Array)
      or x.is_fully_addressable
      or x.is_fully_replicated
  ):
    return np.asarray(x)
  from jax.experimental import multihost_utils

  return np.asarray(multihost_utils.process_allgather(x, tiled=True))
