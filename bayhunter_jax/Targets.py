"""Targets: observed/modeled data containers, valuation, joint target.

API-compatible with the reference (reference: src/Targets.py): the
same six concrete target classes, the duck-typed plugin protocol, the
covariance dispatch, and the sentinel semantics (misfit 1e15 /
log-likelihood -1e15 on invalid forward output).  The host-side
``JointTarget.evaluate`` serves single-model workflows (tutorials,
BayWatch synth recomputation, SynthObs); the MCMC hot path uses the
batched on-device evaluator built from these targets in
sampler/evaluator.py.
"""

import logging

import numpy as np

logger = logging.getLogger(__name__)


class ObservedData(object):
    """Observed x/y(/yerr) container (reference: src/Targets.py:16-30)."""

    def __init__(self, x, y, yerr=None):
        self.x = np.asarray(x, float)
        self.y = None if y is None else np.asarray(y, float)
        if (yerr is None or np.any(np.asarray(yerr) <= 0.)
                or np.any(np.isnan(yerr))):
            self.yerr = np.ones(self.x.size) * np.nan
        else:
            self.yerr = np.asarray(yerr, float)


class ModeledData(object):
    """Synthetic data slot + forward-modeling plugin dispatch
    (reference: src/Targets.py:33-82).

    The final method returning synthetic x and y data must be named
    ``run_model(h, vp, vs, rho, **kwargs)``; replace the plugin with
    your own via ``SingleTarget.update_plugin`` (see templates/)."""

    RF_TARGETS = ('prf', 'srf')
    SWD_TARGETS = ('rdispph', 'ldispph', 'rdispgr', 'ldispgr')

    def __init__(self, obsx, ref):
        if ref in self.RF_TARGETS:
            from bayhunter_jax.forward.rf_plugin import SynRF
            self.plugin = SynRF(obsx, ref)
            self.xlabel = 'Time in s'
        elif ref in self.SWD_TARGETS:
            from bayhunter_jax.forward.swd_plugin import SurfDisp
            self.plugin = SurfDisp(obsx, ref)
            self.xlabel = 'Period in s'
        else:
            logger.info(
                "Please provide a forward modeling plugin for your "
                "target.\nUse target.update_plugin(MyForwardClass())")
            self.plugin = None
            self.xlabel = 'x'

        self.x = np.nan
        self.y = np.nan

    def update(self, plugin):
        self.plugin = plugin

    def calc_synth(self, h, vp, vs, **kwargs):
        rho = kwargs.pop('rho')
        self.x, self.y = self.plugin.run_model(h, vp, vs, rho=rho,
                                               **kwargs)


class Valuation(object):
    """Likelihood/misfit computation methods
    (reference: src/Targets.py:85-183).  Only the likelihood drives
    the Bayesian inversion; RMS misfit is for progress display."""

    def __init__(self):
        self.corr_inv, self.logcorr_det = None, None
        self.misfit, self.likelihood = None, None

    @staticmethod
    def get_rms(yobs, ymod):
        resid = np.asarray(ymod) - np.asarray(yobs)
        return float(np.sqrt(resid.dot(resid) / resid.size))

    @staticmethod
    def get_covariance_nocorr(sigma, size, yerr=None, corr=0):
        c_inv = np.diag(np.ones(size)) / (sigma ** 2)
        logc_det = (2 * size) * np.log(sigma)
        return c_inv, logc_det

    @staticmethod
    def get_covariance_nocorr_scalederr(sigma, size, yerr, corr=0):
        scaled_err = yerr / yerr.min()
        c_inv = np.diag(np.ones(size)) / (scaled_err * sigma ** 2)
        logc_det = (2 * size) * np.log(sigma) + np.sum(np.log(scaled_err))
        return c_inv, logc_det

    @staticmethod
    def get_corr_inv(corr, size):
        # analytic tridiagonal inverse of the exponential law
        cinv = np.zeros((size, size))
        inner = np.arange(1, size - 1)
        cinv[0, 0] = cinv[-1, -1] = 1.0
        cinv[inner, inner] = 1.0 + corr ** 2
        off = np.arange(size - 1)
        cinv[off, off + 1] = cinv[off + 1, off] = -corr
        return cinv

    def get_covariance_exp(self, corr, sigma, size, yerr=None):
        c_inv = self.get_corr_inv(corr, size) \
            / (sigma ** 2 * (1 - corr ** 2))
        logc_det = (2 * size) * np.log(sigma) \
            + (size - 1) * np.log(1 - corr ** 2)
        return c_inv, logc_det

    def init_covariance_gauss(self, corr, size, rcond=None):
        """Dense inverse of the Gaussian correlation matrix — computed
        ONCE per inversion (reference: src/Targets.py:150-160)."""
        from bayhunter_jax.ops.likelihood import init_covariance_gauss
        self.corr_inv, self.logcorr_det = init_covariance_gauss(
            corr, size, rcond=rcond)

    def get_covariance_gauss(self, sigma, size, yerr=None, corr=None):
        c_inv = self.corr_inv / (sigma ** 2)
        logc_det = (2 * size) * np.log(sigma) + self.logcorr_det
        return c_inv, logc_det

    @staticmethod
    def get_likelihood(yobs, ymod, c_inv, logc_det):
        resid = np.asarray(ymod) - np.asarray(yobs)
        mahalanobis = resid @ c_inv @ resid
        n = np.size(yobs)
        return -0.5 * (n * np.log(2 * np.pi) + logc_det + mahalanobis)


class SingleTarget(object):
    """One dataset + its modeled counterpart + valuation
    (reference: src/Targets.py:186-249)."""

    def __init__(self, x, y, ref, yerr=None):
        self.ref = ref
        self.obsdata = ObservedData(x=x, y=y, yerr=yerr)
        self.moddata = ModeledData(obsx=x, ref=ref)
        self.valuation = Valuation()
        logger.info("Initiated target: %s (ref: %s)"
                    % (self.__class__.__name__, self.ref))

    def update_plugin(self, plugin):
        self.moddata.update(plugin)

    def _moddata_valid(self):
        obs, mod = self.obsdata, self.moddata
        return (isinstance(mod.x, np.ndarray)
                and len(obs.x) == len(mod.x)
                and len(obs.y) == len(mod.y)
                and np.sum(obs.x - mod.x) <= 1e-5)

    def calc_misfit(self):
        if not self._moddata_valid():
            self.valuation.misfit = 1e15
            return
        self.valuation.misfit = self.valuation.get_rms(
            self.obsdata.y, self.moddata.y)

    def calc_likelihood(self, c_inv, logc_det):
        if not self._moddata_valid():
            self.valuation.likelihood = -1e15
            return
        self.valuation.likelihood = self.valuation.get_likelihood(
            self.obsdata.y, self.moddata.y, c_inv, logc_det)

    def plot(self, ax=None, mod=True):
        import matplotlib.pyplot as plt
        if ax is None:
            fig, ax = plt.subplots()
        ax.errorbar(self.obsdata.x, self.obsdata.y, yerr=self.obsdata.yerr,
                    label='obs', marker='x', ms=1, color='blue', lw=0.8,
                    elinewidth=0.7, zorder=1000)
        if mod:
            ax.plot(self.moddata.x, self.moddata.y, label='mod',
                    marker='o', ms=1, color='red', lw=0.7, alpha=0.5)
        ax.set_ylabel(self.ref)
        ax.set_xlabel(self.moddata.xlabel)
        return ax


class RayleighDispersionPhase(SingleTarget):
    noiseref = 'swd'

    def __init__(self, x, y, yerr=None):
        SingleTarget.__init__(self, x, y, 'rdispph', yerr=yerr)


class RayleighDispersionGroup(SingleTarget):
    noiseref = 'swd'

    def __init__(self, x, y, yerr=None):
        SingleTarget.__init__(self, x, y, 'rdispgr', yerr=yerr)


class LoveDispersionPhase(SingleTarget):
    noiseref = 'swd'

    def __init__(self, x, y, yerr=None):
        SingleTarget.__init__(self, x, y, 'ldispph', yerr=yerr)


class LoveDispersionGroup(SingleTarget):
    noiseref = 'swd'

    def __init__(self, x, y, yerr=None):
        SingleTarget.__init__(self, x, y, 'ldispgr', yerr=yerr)


class PReceiverFunction(SingleTarget):
    noiseref = 'rf'

    def __init__(self, x, y, yerr=None):
        SingleTarget.__init__(self, x, y, 'prf', yerr=yerr)


class SReceiverFunction(SingleTarget):
    noiseref = 'rf'

    def __init__(self, x, y, yerr=None):
        SingleTarget.__init__(self, x, y, 'srf', yerr=yerr)


class JointTarget(object):
    """List of SingleTargets + joint likelihood
    (reference: src/Targets.py:300-373)."""

    def __init__(self, targets):
        self.targets = targets
        self.ntargets = len(targets)

    def get_misfits(self):
        misfits = [target.valuation.misfit for target in self.targets]
        jointmisfit = np.sum(misfits)
        return np.concatenate((misfits, [jointmisfit]))

    def evaluate(self, h, vp, vs, noise, **kwargs):
        """Joint likelihood/misfit of one model on the host
        (reference: src/Targets.py:314-347).  Sets
        ``proposallikelihood``/``proposalmisfits``; invalid forward
        output short-circuits to the sentinels."""
        rho = kwargs.pop('rho', vp * 0.32 + 0.77)

        logL = 0
        for n, target in enumerate(self.targets):
            target.moddata.calc_synth(h=h, vp=vp, vs=vs, rho=rho,
                                      **kwargs)
            if not target._moddata_valid():
                self.proposallikelihood = -1e15
                self.proposalmisfits = [1e15] * (self.ntargets + 1)
                return

            target.calc_misfit()

            size = target.obsdata.y.size
            yerr = target.obsdata.yerr
            corr, sigma = noise[2 * n:2 * n + 2]
            c_inv, logc_det = target.get_covariance(
                sigma=sigma, size=size, yerr=yerr, corr=corr)

            ydiff = target.moddata.y - target.obsdata.y
            madist = (ydiff.T).dot(c_inv).dot(ydiff)
            logL_part = -0.5 * (size * np.log(2 * np.pi) + logc_det)
            logL += logL_part - madist / 2.

        self.proposallikelihood = logL
        self.proposalmisfits = self.get_misfits()

    def plot_obsdata(self, ax=None, mod=False):
        """Subplots of all targets (reference: src/Targets.py:349-373)."""
        import matplotlib.pyplot as plt
        if len(self.targets) == 1:
            if ax is None:
                fig, ax = plt.subplots(figsize=(7, 3.2))
            else:
                fig = ax.figure
            ax = self.targets[0].plot(ax=ax, mod=mod)
            ax.legend()
        else:
            if ax is None:
                fig, ax = plt.subplots(self.ntargets,
                                       figsize=(6, 3.2 * self.ntargets))
            else:
                fig = ax[0].figure
            for i, target in enumerate(self.targets):
                ax[i] = target.plot(ax=ax[i], mod=mod)
            han, lab = ax[0].get_legend_handles_labels()
            ax[0].legend(han, lab)
        return fig, ax
