"""Distribution (counterpart of ``repro.distributed``): checkpoints
(``checkpoint``, whole or sharded), the sharding rules (``sharding``),
tensor and data parallel execution over a mesh of ranks
(``tensor_parallel``, its collectives in ``collectives``) and the int8
ring all-reduce (``compress``)."""
from . import checkpoint

__all__ = ["checkpoint"]
