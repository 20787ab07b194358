"""End-to-end joint SWD + RF inversion of the synthetic station "st3".

Accelerator equivalent of the reference tutorial workflow
(reference: tutorial/tutorialhunt.py): load config, add correlated
noise with known hyperparameters to the synthetic observables, invert
jointly, then post-process and plot.  Unlike the reference there is no
BLAS-thread pinning or process pool — all chains run as one batched
device program.

Run ``python create_testdata.py`` first to generate observed/.
"""

import logging
import os.path as op
import sys

import numpy as np
import matplotlib
matplotlib.use('PDF')

sys.path.insert(0, op.join(op.dirname(__file__), '..'))
from bayhunter_jax import (Targets, utils, MCMC_Optimizer,  # noqa: E402
                           PlotFromStorage, SynthObs)

formatter = ' %(processName)-12s: %(levelname)-8s |  %(message)s'
logging.basicConfig(format=formatter, level=logging.INFO)

here = op.dirname(__file__) or '.'

# ----------------------------------------------------------- observed data
priors, initparams = utils.load_params(op.join(here, 'config.ini'))

xsw, _ysw = np.loadtxt(op.join(here, 'observed/st3_rdispph.dat')).T
xrf, _yrf = np.loadtxt(op.join(here, 'observed/st3_prf.dat')).T

# inject correlated noise with KNOWN (corr, sigma) per target — the
# posterior must recover these (exponential law for SWD, Gaussian for RF)
noise = [0.0, 0.012, 0.98, 0.005]
ysw_err = SynthObs.compute_expnoise(_ysw, corr=noise[0], sigma=noise[1])
ysw = _ysw + ysw_err
yrf_err = SynthObs.compute_gaussnoise(_yrf, corr=noise[2], sigma=noise[3])
yrf = _yrf + yrf_err

# ------------------------------------------- reference model for plots/GUI
dep, vs = np.loadtxt(op.join(here, 'observed/st3_mod.dat'),
                     usecols=[0, 2], skiprows=1).T
pdep = np.concatenate((np.repeat(dep, 2)[1:], [150]))
pvs = np.repeat(vs, 2)

truenoise = np.concatenate(([noise[0]], [np.std(ysw_err)],
                            [noise[2]], [np.std(yrf_err)]))
explike = SynthObs.compute_explike(yobss=[ysw, yrf], ymods=[_ysw, _yrf],
                                   noise=truenoise, gauss=[False, True],
                                   rcond=initparams['rcond'])
truemodel = {'model': (pdep, pvs), 'nlays': 3,
             'noise': truenoise, 'explike': explike}
print('true noise:', truenoise, ' expected logL:', explike)

# ----------------------------------------------------------------- targets
target1 = Targets.RayleighDispersionPhase(xsw, ysw, yerr=ysw_err)
target2 = Targets.PReceiverFunction(xrf, yrf)
target2.moddata.plugin.set_modelparams(gauss=1., water=0.01, p=6.4)
targets = Targets.JointTarget(targets=[target1, target2])

priors.update({'mohoest': None, 'rfnoise_corr': 0.98,
               'swdnoise_corr': 0.})
initparams.update({'nchains': 21,
                   'iter_burnin': (2048 * 16),
                   'iter_main': (2048 * 8),
                   'propdist': (0.025, 0.025, 0.015, 0.005, 0.005),
                   # RECOMMENDED primary configuration: the exact
                   # truncated-subspace Gaussian law.  The rcond-
                   # truncated parity law (the library default,
                   # gauss_dof_correction=False) reproduces the
                   # reference's sigma_RF bias — sigma MLE =
                   # sqrt(k/n)*sigma, ~0.55x injected here — and the
                   # over-parametrized layer-count mode that feeds on
                   # it; the corrected law recovers the injected
                   # sigma_RF and the reference's DOCUMENTED 5-6
                   # layer posterior family (A/B matrix:
                   # VALIDATION.md, scripts/ab_layer_posterior.py).
                   'gauss_dof_correction': True,
                   'savepath': op.join(here, 'results')})

# --------------------------------------------------------------- inversion
utils.save_baywatch_config(targets, path=here, priors=priors,
                           initparams=initparams, refmodel=truemodel)
optimizer = MCMC_Optimizer(targets, initparams=initparams,
                           priors=priors, random_seed=None)
# baywatch=True live-streams over ZMQ; watch with `scripts/baywatch .`
optimizer.mp_inversion(baywatch=True, dtsend=1)

# ------------------------------------------------------------ post-process
configfile = op.join(initparams['savepath'], 'data',
                     '%s_config.pkl' % initparams['station'])
obj = PlotFromStorage(configfile)
obj.save_final_distribution(maxmodels=100000, dev=0.05)
obj.save_plots(refmodel=truemodel)
obj.merge_pdfs()
