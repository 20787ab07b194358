"""On-device transdimensional Metropolis-Hastings sampler.

The reference's process-per-chain sequential loop
(reference: src/SingleChain.py:591-644) becomes:
  * chains = a vmapped/shard_mapped batch axis,
  * iterations = a lax.scan with a carried ChainState pytree,
  * posterior storage = periodic state snapshots (statistically
    identical to the reference's accepted-model weighting).
"""

from bayhunter_jax.sampler.chain import (ChainState, SamplerConfig,  # noqa: F401
                                         SingleChain, build_sampler)
from bayhunter_jax.sampler.evaluator import build_evaluator  # noqa: F401
