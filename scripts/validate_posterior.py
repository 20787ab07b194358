"""Condensed posterior-recovery validation (VALIDATION.md).

Runs the tutorial joint SWD+RF inversion (512 chains) through the full
production path (MCMC_Optimizer -> batched sampler -> .npy contract)
and checks the pooled better-half posterior against the known truth:

  * median log-likelihood ~ analytic expected likelihood
  * vs at probe depths ~ true 4-layer model (within ~0.03 km/s)
  * RF rms residual ~ injected sigma_RF
  * sigma_SWD ~ realized noise std

Usage:  python scripts/validate_posterior.py [nchains] [burnin] [main]
"""

import os.path as op
import shutil
import sys
import time

import numpy as np

sys.path.insert(0, op.join(op.dirname(__file__), '..'))

from bayhunter_jax import (Targets, utils, MCMC_Optimizer,  # noqa: E402
                           SynthObs)
from bayhunter_jax.models import Model  # noqa: E402

NCHAINS = int(sys.argv[1]) if len(sys.argv) > 1 else 512
BURNIN = int(sys.argv[2]) if len(sys.argv) > 2 else 2048 * 16
MAIN = int(sys.argv[3]) if len(sys.argv) > 3 else 2048 * 8

here = op.join(op.dirname(__file__), '..', 'tutorial')
savepath = op.join(op.dirname(__file__), '..', 'results',
                   'validate_posterior')


def main():
    if op.exists(savepath):
        shutil.rmtree(savepath)

    priors, initparams = utils.load_params(op.join(here, 'config.ini'))
    xsw, _ysw = np.loadtxt(op.join(here,
                                   'observed/st3_rdispph.dat')).T
    xrf, _yrf = np.loadtxt(op.join(here, 'observed/st3_prf.dat')).T

    noise = [0.0, 0.012, 0.98, 0.005]
    ysw_err = SynthObs.compute_expnoise(_ysw, corr=noise[0],
                                        sigma=noise[1])
    ysw = _ysw + ysw_err
    yrf_err = SynthObs.compute_gaussnoise(_yrf, corr=noise[2],
                                          sigma=noise[3])
    yrf = _yrf + yrf_err

    truenoise = np.concatenate(([noise[0]], [np.std(ysw_err)],
                                [noise[2]], [np.std(yrf_err)]))
    explike = SynthObs.compute_explike(
        yobss=[ysw, yrf], ymods=[_ysw, _yrf], noise=truenoise,
        gauss=[False, True], rcond=initparams['rcond'])

    target1 = Targets.RayleighDispersionPhase(xsw, ysw, yerr=ysw_err)
    target2 = Targets.PReceiverFunction(xrf, yrf)
    target2.moddata.plugin.set_modelparams(gauss=1., water=0.01, p=6.4)
    targets = Targets.JointTarget(targets=[target1, target2])

    priors.update({'mohoest': None, 'rfnoise_corr': 0.98,
                   'swdnoise_corr': 0.})
    initparams.update({'nchains': NCHAINS,
                       'iter_burnin': BURNIN,
                       'iter_main': MAIN,
                       'propdist': (0.025, 0.025, 0.015, 0.005, 0.005),
                       'savepath': savepath})
    t0 = time.time()
    optimizer = MCMC_Optimizer(targets, initparams=initparams,
                               priors=priors, random_seed=7)
    optimizer.mp_inversion(baywatch=False)
    dt = time.time() - t0
    nprop = NCHAINS * (BURNIN + MAIN)
    print('inversion: %.0f s for %d proposals (%.0f proposals/s)'
          % (dt, nprop, nprop / dt))

    from bayhunter_jax.plotting import PlotFromStorage
    configfile = op.join(savepath, 'data',
                         '%s_config.pkl' % initparams['station'])
    obj = PlotFromStorage(configfile)
    obj.save_final_distribution(maxmodels=100000, dev=0.05)

    data = op.join(savepath, 'data')
    models = np.load(op.join(data, 'c_models.npy'))
    likes = np.load(op.join(data, 'c_likes.npy'))
    misfits = np.load(op.join(data, 'c_misfits.npy'))
    noises = np.load(op.join(data, 'c_noise.npy'))
    vpvss = np.load(op.join(data, 'c_vpvs.npy'))

    good = likes >= np.median(likes)   # pooled better half
    models, likes = models[good], likes[good]
    misfits, noises, vpvss = misfits[good], noises[good], vpvss[good]

    probes = [2.5, 15.0, 32.0, 50.0]
    truth = [2.7, 3.6, 3.8, 4.4]
    vs_at = {p: [] for p in probes}
    for m, vv in zip(models[::max(1, len(models) // 20000)],
                     vpvss[::max(1, len(models) // 20000)]):
        vp, vs, h = Model.get_vp_vs_h(m, vv)
        zb = np.cumsum(h)
        zb[-1] = 1e4
        for p in probes:
            vs_at[p].append(vs[np.searchsorted(zb, p)])

    print('\nmedian logL %.1f  (expected %.1f)'
          % (np.median(likes), explike))
    ok = True
    for p, tv in zip(probes, truth):
        med = np.median(vs_at[p])
        good_p = abs(med - tv) < 0.05
        ok &= good_p
        print('vs at z=%4.1f km: %.3f  (truth %.1f)  %s'
              % (p, med, tv, 'OK' if good_p else 'FAIL'))
    sig_swd = np.median(noises[:, 1])
    rms_rf = np.median(misfits[:, 1])
    print('sigma_SWD median %.4f  (realized %.4f)'
          % (sig_swd, truenoise[1]))
    print('RF rms residual median %.4f  (injected %.4f)'
          % (rms_rf, np.std(yrf_err)))
    ok &= abs(np.median(likes) - explike) < 150
    ok &= abs(rms_rf - np.std(yrf_err)) < 0.002
    print('\nVALIDATION', 'PASSED' if ok else 'FAILED')
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())
