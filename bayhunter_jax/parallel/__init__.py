from bayhunter_jax.parallel.tomo import TomoInversion  # noqa: F401
from bayhunter_jax.parallel.mesh import (chain_sharding,  # noqa: F401
                                         shard_states)
