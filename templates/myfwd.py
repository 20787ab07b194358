"""Template: a user-defined forward-model plugin.

Mirrors the reference extension point (reference:
templates/myfwd.py:13-53), extended with the device contract: to run
inside the on-device sampler, the plugin must ALSO provide a
JAX-traceable ``run_model_jax``.

Two entry points:

  * ``run_model(h, vp, vs, rho, **kwargs) -> (x, y)`` — host-side
    protocol used by SynthObs, plotting and BayWatch data-fit redraws
    (duck-typed like the reference, reference: src/Targets.py:75-82).
    Return ``(nan, nan)``-filled arrays on failure.
  * ``run_model_jax(h, vp, vs, rho) -> y`` — device-side protocol used
    by the McMC sampler.  MUST be jit-traceable with FIXED shapes:
    inputs are (NL,) padded layer arrays (halfspace last, zero
    thickness padding — see bayhunter_jax/ops/voronoi.py) and the
    output must always have shape (ndata,).  Signal failure through
    non-finite values in ``y`` (they map to the sentinel likelihood,
    reference: src/Targets.py:325-328).
"""

import numpy as np
import jax.numpy as jnp


class MyForwardModel(object):

    def __init__(self, obsx, ref):
        self.obsx = np.asarray(obsx)
        self.ref = ref
        self.modelparams = {}

    def set_modelparams(self, **mparams):
        self.modelparams.update(mparams)

    def run_model_jax(self, h, vp, vs, rho):
        """Device forward model: (NL,) padded layers -> (ndata,)."""
        # --- replace with your physics ---
        obsx = jnp.asarray(self.obsx, h.dtype)
        return jnp.full(obsx.shape, jnp.mean(vs), h.dtype)

    def run_model(self, h, vp, vs, rho, **kwargs):
        """Host forward model: unpadded layers -> (x, y)."""
        y = np.asarray(self.run_model_jax(
            jnp.asarray(h), jnp.asarray(vp), jnp.asarray(vs),
            jnp.asarray(rho)))
        return self.obsx, y
