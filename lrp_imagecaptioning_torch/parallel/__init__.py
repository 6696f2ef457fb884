"""Scale-out over several devices and processes (``mesh.py``,
``distributed.py``): the port of the JAX package's ``parallel/``."""

from .distributed import (  # noqa: F401
    all_reduce_sum,
    global_batch_from_local,
    global_stacked_batch_from_local,
    initialize_distributed,
    make_multihost_mesh,
    process_batch_slice,
    shard_global_batch,
)
from .mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    NamedSharding,
    P,
    Sharded,
    VocabSlices,
    as_sharded,
    as_stacked,
    batch_sharding,
    decoder_param_pspecs,
    gather_params,
    make_mesh,
    opt_state_shardings,
    param_shardings,
    place_params,
    replicated,
    shard_batch,
    stacked_batch_sharding,
)
