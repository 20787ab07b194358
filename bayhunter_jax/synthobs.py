"""Synthetic 'observed' data generation and expected likelihood.

API-compatible with the reference ``SynthObs``
(reference: src/SynthObs.py): forward-models all six target types for
a given (h, vs, vpvs), draws exponentially/Gaussian-correlated noise,
and computes the expected likelihood oracle used by BayWatch and the
test suite.
"""

import logging
import os

import numpy as np

from bayhunter_jax import Targets
from bayhunter_jax.ops.likelihood import (exp_correlation_matrix,
                                          gauss_correlation_matrix)

logger = logging.getLogger(__name__)

rstate = np.random.RandomState(333)


class SynthObs():
    """Compute synthetic data, synthetic correlated noise, and the
    expected likelihood of the true model."""

    @staticmethod
    def return_swddata(h, vs, vpvs=1.73, pars=dict(), x=None):
        """Forward-model all 4 SWD targets
        (reference: src/SynthObs.py:24-55)."""
        if x is None:
            x = np.linspace(1, 40, 20)
        h = np.array(h, float)
        vs = np.array(vs, float)
        mode = pars.get('mode', 1)

        targets = [Targets.RayleighDispersionPhase(x=x, y=None),
                   Targets.RayleighDispersionGroup(x=x, y=None),
                   Targets.LoveDispersionPhase(x=x, y=None),
                   Targets.LoveDispersionGroup(x=x, y=None)]
        for target in targets:
            target.moddata.plugin.set_modelparams(mode=mode)

        vp = vs * vpvs
        rho = vp * 0.32 + 0.77

        data = {}
        for target in targets:
            xmod, ymod = target.moddata.plugin.run_model(
                h=h, vp=vp, vs=vs, rho=rho)
            data[target.ref] = np.array([xmod, ymod])
        logger.info('Compute SWD for %d periods, with model vp/vs %.2f.'
                    % (np.size(x), vpvs))
        return data

    @staticmethod
    def return_rfdata(h, vs, vpvs=1.73, pars=dict(), x=None):
        """Forward-model both RF targets
        (reference: src/SynthObs.py:57-99)."""
        if x is None:
            x = np.linspace(-5, 35, 201)
        h = np.array(h, float)
        vs = np.array(vs, float)

        gauss = pars.get('gauss', 1.0)
        water = pars.get('water', 0.001)
        p = pars.get('p', 6.4)
        nsv = pars.get('nsv', None)

        targets = [Targets.PReceiverFunction(x=x, y=None),
                   Targets.SReceiverFunction(x=x, y=None)]
        for target in targets:
            target.moddata.plugin.set_modelparams(
                gauss=gauss, water=water, p=p, nsv=nsv)

        vp = vs * vpvs
        rho = vp * 0.32 + 0.77

        data = {}
        for target in targets:
            xmod, ymod = target.moddata.plugin.run_model(
                h=h, vp=vp, vs=vs, rho=rho)
            data[target.ref] = np.array([xmod, ymod])

        logger.info('Compute RF with gauss: %.2f, waterlevel: %.4f, '
                    'slowness: %.2f' % (gauss, water, p))
        return data

    @staticmethod
    def save_data(data, outfile=None):
        """Save data dictionary as ASCII files
        (reference: src/SynthObs.py:101-116)."""
        if outfile is None:
            outfile = 'syn_%s.dat'
        if '%s' not in outfile:
            name, ext = os.path.splitext(outfile)
            outfile = name + '_%s' + ext
        for ref, (x, y) in data.items():
            np.savetxt(outfile % ref,
                       np.column_stack([np.asarray(x), np.asarray(y)]),
                       fmt='%.4f', delimiter='\t')
            logger.info('Data file saved: %s' % (outfile % ref))

    @staticmethod
    def save_model(h, vs, vpvs=1.73, outfile=None):
        """Save input model as ASCII file
        (reference: src/SynthObs.py:118-133)."""
        h = np.array(h, float)
        vs = np.array(vs, float)
        vp = vs * vpvs
        rho = vp * 0.32 + 0.77
        if outfile is None:
            outfile = 'syn_mod.dat'
        x = np.arange(10)
        target = Targets.PReceiverFunction(x=x, y=None)
        target.moddata.plugin.write_startmodel(h, vp, vs, rho, outfile)
        logger.info('Model file saved: %s' % outfile)

    @staticmethod
    def compute_expnoise(data_obs, corr=0.85, sigma=0.0125):
        """Exponentially correlated noise draw
        (reference: src/SynthObs.py:135-143)."""
        size = np.size(data_obs)
        Ce = sigma ** 2 * exp_correlation_matrix(corr, size)
        return rstate.multivariate_normal(np.zeros(size), Ce)

    @staticmethod
    def compute_gaussnoise(data_obs, corr=0.85, sigma=0.0125):
        """Gaussian correlated noise draw — use for RF if a Gauss
        filter was applied (reference: src/SynthObs.py:145-155)."""
        size = np.size(data_obs)
        Ce = sigma ** 2 * gauss_correlation_matrix(corr, size)
        return rstate.multivariate_normal(np.zeros(size), Ce)

    @staticmethod
    def _nocorr(sigma, size):
        c_inv = np.diag(np.ones(size)) / (sigma ** 2)
        logc_det = (2 * size) * np.log(sigma)
        return c_inv, logc_det

    @staticmethod
    def _gausscorr(sigma, size, corr, rcond=None):
        rmatrix = gauss_correlation_matrix(corr, size)
        if rcond is not None:
            corr_inv = np.linalg.pinv(rmatrix, rcond=rcond)
        else:
            corr_inv = np.linalg.inv(rmatrix)
        _, logcorr_det = np.linalg.slogdet(rmatrix)
        c_inv = corr_inv / (sigma ** 2)
        logc_det = (2 * size) * np.log(sigma) + logcorr_det
        return c_inv, logc_det

    @staticmethod
    def _expcorr(sigma, size, corr):
        d = np.ones(size) + corr ** 2
        d[0] = d[-1] = 1
        e = np.ones(size - 1) * -corr
        corr_inv = np.diag(d) + np.diag(e, k=1) + np.diag(e, k=-1)
        c_inv = corr_inv / (sigma ** 2 * (1 - corr ** 2))
        logc_det = (2 * size) * np.log(sigma) \
            + (size - 1) * np.log(1 - corr ** 2)
        return c_inv, logc_det

    @staticmethod
    def compute_explike(yobss=[], ymods=[], noise=[], gauss=[],
                        rcond=None):
        """Expected log-likelihood of the true model under injected
        noise; BayWatch reference line
        (reference: src/SynthObs.py:193-222)."""
        logL = 0
        for n in range(len(yobss)):
            ydiff = ymods[n] - yobss[n]
            size = ydiff.size
            corr, sigma = noise[2 * n:2 * n + 2]
            if corr == 0:
                c_inv, logc_det = SynthObs._nocorr(sigma, size)
            elif gauss[n]:
                c_inv, logc_det = SynthObs._gausscorr(sigma, size, corr,
                                                      rcond=rcond)
            else:
                c_inv, logc_det = SynthObs._expcorr(sigma, size, corr)

            madist = (ydiff.T).dot(c_inv).dot(ydiff)
            logL_part = -0.5 * (size * np.log(2 * np.pi) + logc_det)
            logL += logL_part - madist / 2.
        return logL
