"""Batched device solvers (plain JAX/XLA): dispersion, reflectivity,
likelihood, model parametrization."""

from bayhunter_jax.ops import (likelihood, rf, rf_pd,  # noqa: F401
                               swd, voronoi)
