"""Forward-model plugins: thin host-facing wrappers around the batched
JAX kernels in ops/, duck-type compatible with the reference plugin
protocol ``run_model(h, vp, vs, rho, **kw) -> (x, y)`` +
``set_modelparams(**kw)`` (reference: src/Targets.py:46-49)."""

from bayhunter_jax.forward.swd_plugin import SurfDisp  # noqa: F401
from bayhunter_jax.forward.rf_plugin import SynRF  # noqa: F401

# reference plugin class name alias for drop-in use
RFminiModRF = SynRF
