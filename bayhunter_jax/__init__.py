"""bayhunter_jax — transdimensional Bayesian inversion of
receiver functions and surface wave dispersion.

A from-scratch JAX/XLA rebuild of the capabilities of BayHunter
(Dreiling & Tilmann 2019): many Metropolis-Hastings Markov chains
sample a transdimensional 1-D earth model (variable number of Voronoi
nuclei + vp/vs + per-target noise hyperparameters); every proposal is
forward-modeled (surface-wave dispersion, receiver functions) and
scored with a correlated-Gaussian likelihood.  Chains are a batch axis
(vmap on one device, shard_map across devices), iterations are a lax.scan, and
the forward solvers are fixed-shape masked JAX kernels.

Public API mirrors the reference package (reference: src/__init__.py).
"""

__version__ = '0.1.0'

from bayhunter_jax import ops  # noqa: F401

# Reference-parity names are re-exported lazily as modules land:
#   Targets, Model, ModelMatrix, SingleChain, MCMC_Optimizer,
#   PlotFromStorage, SynthObs
# name -> (module, attr); attr None means the module itself is the export
_PARITY_EXPORTS = {
    'Model': ('bayhunter_jax.models', 'Model'),
    'ModelMatrix': ('bayhunter_jax.models', 'ModelMatrix'),
    'Targets': ('bayhunter_jax.Targets', None),
    'SynthObs': ('bayhunter_jax.synthobs', 'SynthObs'),
    'MCMC_Optimizer': ('bayhunter_jax.optimizer', 'MCMC_Optimizer'),
    'SingleChain': ('bayhunter_jax.sampler.chain', 'SingleChain'),
    'PlotFromStorage': ('bayhunter_jax.plotting', 'PlotFromStorage'),
    'BayWatcher': ('bayhunter_jax.baywatch', 'BayWatcher'),
    'utils': ('bayhunter_jax.utils', None),
    # beyond-reference: ensemble convergence diagnostics
    'diagnostics': ('bayhunter_jax.diagnostics', None),
}


def __getattr__(name):
    if name in _PARITY_EXPORTS:
        import importlib
        modname, attr = _PARITY_EXPORTS[name]
        mod = importlib.import_module(modname)
        return mod if attr is None else getattr(mod, attr)
    raise AttributeError(name)
