"""Multi-host runtime entry.

Counterpart of the reference's node bring-up (mtssrv + the -c host list,
mitsuba.cpp:296-314): there is no user-level message loop —
`jax.distributed.initialize` joins the processes (one per host), a
global Mesh spans every device, and the same shard_map render step
(parallel.render) runs SPMD; XLA hands the collectives to NCCL on
GPUs.

Usage on each host:
    from alvrl_tpu.parallel import multihost
    multihost.initialize(addr, n, i) # one call per process
    mesh = multihost.global_mesh()   # ('rays', 'vrls') over all chips
"""

from __future__ import annotations

import jax

from alvrl_tpu.parallel.mesh import make_mesh


def initialize(coordinator_address=None, num_processes=None, process_id=None):
    """Join the multi-host runtime (jax.distributed semantics). Pass
    the coordinator address, process count and this process's id: no
    cluster environment supplies them."""
    kwargs = {}
    if coordinator_address is not None:
        kwargs = dict(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    jax.distributed.initialize(**kwargs)


def global_mesh(shape=None):
    """Mesh over every device of every process."""
    return make_mesh(len(jax.devices()), shape=shape)


def is_primary() -> bool:
    return jax.process_index() == 0
