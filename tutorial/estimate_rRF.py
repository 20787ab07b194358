"""Estimate the receiver-function noise correlation r_RF from the
Gauss filter width used when computing the observed RFs
(reference workflow: tutorial/estimate_rRF.py; method:
src/utils.py:357-395 — fit a Gaussian envelope to correlated-noise
spectra and map filter width a <-> r_RF)."""

import os.path as op
import sys

import numpy as np

sys.path.insert(0, op.join(op.dirname(__file__), '..'))
from bayhunter_jax import utils  # noqa: E402

here = op.dirname(__file__) or '.'

rfx = np.loadtxt(op.join(here, 'observed/st3_prf.dat'), usecols=[0])
pars = {
    'rfx': rfx,        # RF time axis (sets dt)
    'draws': 2000,     # noise realizations averaged per candidate
    'rrfs': [0.95, 0.96, 0.97, 0.98, 0.99],  # candidate correlations
}

rrfs, a_est = utils.rrf_estimate(pars=pars)
for r, a in zip(rrfs, a_est):
    print('rfnoise_corr %.3f  <->  Gauss filter width a = %.3f'
          % (r, a))
utils.plot_rrf_estimate(pars=pars)
