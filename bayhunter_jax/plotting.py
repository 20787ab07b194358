"""Post-processing & plotting from saved chain files.

Drop-in replacement for the reference ``PlotFromStorage``
(reference: src/Plotting.py:47-1271): reads the per-chain
``c???_p{1,2}*.npy`` files plus the config pickle, flags outlier
chains, assembles the final posterior distribution and renders the
posterior summary figures and the merged ``c_summary.pdf``.

Internally organized differently from the reference: a cached
file-store front-end (:class:`_ChainStore`) feeds small composable
figure helpers; the public methods keep the reference's names,
signatures and output-file contract.

Differences from the reference:
  * PDF merging prefers pypdf and falls back to an incremental
    PdfPages collector (PyPDF2 is not required).
  * file loads are cached; ensemble statistics are vectorized.
"""

import glob
import logging
import os
import os.path as op

import numpy as np

import matplotlib
import matplotlib.pyplot as plt

from bayhunter_jax import utils
from bayhunter_jax import Targets
from bayhunter_jax.models import Model, ModelMatrix

logger = logging.getLogger(__name__)

_SUBSAMPLE_SEED = 333      # reference uses a fixed seed for subsampling
FTYPES = ('models', 'likes', 'misfits', 'noise', 'vpvs')


def vs_round(vs):
    """Snap to the 0.025 km/s grid used for vs histograms
    (reference: src/Plotting.py:29-32)."""
    base = np.floor(vs)
    return base + np.round((vs - base) * 40) / 40


def tryexcept(func):
    """Render errors per-figure instead of aborting the whole report
    (the reference guards every plot method the same way)."""
    def guarded(*args, **kwargs):
        try:
            return func(*args, **kwargs)
        except Exception as exc:
            print('* %s: Plotting was not possible\nErrorMessage: %s'
                  % (func.__name__, exc))
            return None
    return guarded


def _rainbow(n):
    return matplotlib.colormaps['rainbow'](np.linspace(0, 1, max(n, 1)))


def _hist_panel(ax, values, bins, fmt='%.2f'):
    """A posterior histogram panel: bars, median line, median text."""
    ax.hist(values, bins=bins, color='darkblue', alpha=0.7,
            edgecolor='white', linewidth=0.4)
    med = np.median(values)
    ax.axvline(med, color='k', ls=':', lw=1)
    if fmt is not None:
        ax.text(0.97, 0.97, 'median: ' + fmt % med, fontsize=9,
                color='k', ha='right', va='top', transform=ax.transAxes)
    ax.set_yticks([])
    for side in ('top', 'right'):
        ax.spines[side].set_visible(False)
    return ax


def _constant_panel(ax, value):
    """Panel for a parameter that was fixed during the inversion."""
    ax.text(0.5, 0.5, 'constant: %.2f' % value, ha='center',
            va='center', transform=ax.transAxes, fontsize=12)
    ax.set_xticks([])
    ax.set_yticks([])
    for side in ('top', 'right'):
        ax.spines[side].set_visible(False)
    return ax


def _nlayer_bins(layers):
    return np.arange(layers.min(), layers.max() + 2) - 0.5


def _profile_from_vector(model, vpvs, mantle):
    """(vs_steps, depth_steps) plotting polyline of one model vector."""
    vp, vs, h = Model.get_vp_vs_h(model, vpvs, mantle)
    _, vs_step, dep_step = Model.get_stepmodel_from_h(h=h, vs=vs, vp=vp)
    return vs_step, dep_step, (vp, vs, h)


class _ChainStore(object):
    """Cached access to the per-chain result files of one inversion."""

    def __init__(self, datapath):
        self.datapath = datapath
        self._cache = {}
        # chain indices present (from the phase-2 likes files)
        self.chains = sorted(
            int(op.basename(f)[1:4]) for f in
            glob.glob(op.join(datapath, 'c???_p2likes.npy')))
        missing = [ft for ft in FTYPES
                   for ph in (1, 2)
                   if len(self.files(ft, ph)) != len(self.chains)]
        if missing:
            logger.info('You are missing files. Please check "%s" for '
                        'completeness (%s).' % (datapath, set(missing)))

    def files(self, ftype, phase):
        return sorted(glob.glob(op.join(
            self.datapath, 'c???_p%d%s.npy' % (phase, ftype))))

    def load(self, cidx, ftype, phase=2):
        key = (cidx, ftype, phase)
        if key not in self._cache:
            path = op.join(self.datapath,
                           'c%.3d_p%d%s.npy' % (cidx, phase, ftype))
            self._cache[key] = np.load(path)
        return self._cache[key]

    def final(self, ftype):
        key = ('final', ftype)
        if key not in self._cache:
            self._cache[key] = np.load(
                op.join(self.datapath, 'c_%s.npy' % ftype))
        return self._cache[key]

    def chain_medlikes(self):
        return np.array([np.median(self.load(c, 'likes'))
                         for c in self.chains])


class PlotFromStorage(object):
    """Posterior report builder working purely from saved files."""

    def __init__(self, configfile):
        meta = utils.read_config(configfile)
        self.targets = meta['targets']
        self.ntargets = len(self.targets)
        self.refs = meta['targetrefs'] + ['joint']
        self.priors = meta['priors']
        self.initparams = meta['initparams']
        self.mantle = self.priors.get('mantle', None)

        self.datapath = op.dirname(configfile)
        self.figpath = self.datapath.replace('data', '')
        print('Current data path: %s' % self.datapath)

        self.store = _ChainStore(self.datapath)
        self.init_filelists()
        self.init_outlierlist()

        self.refmodel = {'model': None, 'nlays': None,
                         'noise': None, 'vpvs': None}
        self._summary_pdf = None

    # ------------------------------------------------------------ setup

    def read_config(self, configfile):
        return utils.read_config(configfile)

    def init_filelists(self):
        """Reference-compatible file-list attributes."""
        by_type = {ft: [self.store.files(ft, 1), self.store.files(ft, 2)]
                   for ft in FTYPES}
        self.modfiles = by_type['models']
        self.likefiles = by_type['likes']
        self.misfiles = by_type['misfits']
        self.noisefiles = by_type['noise']
        self.vpvsfiles = by_type['vpvs']

    def init_outlierlist(self):
        path = op.join(self.datapath, 'outliers.dat')
        if op.exists(path):
            self.outliers = np.loadtxt(path, usecols=[0], dtype=int,
                                       ndmin=1)
            print('Outlier chains from file: %d' % self.outliers.size)
        else:
            print('Outlier chains from file: None')
            self.outliers = np.zeros(0)

    # --------------------------------------------------- posterior merge

    def get_outliers(self, dev):
        """Chains whose median likelihood deviates more than ``dev``
        (relative) from the best chain's
        (reference: src/Plotting.py:113-154)."""
        medians = self.store.chain_medlikes()
        chains = np.asarray(self.store.chains)
        top = medians.max()
        scores = medians / top if top > 0 else top / medians
        bad = (1 - scores) > dev
        outliers = chains[bad]
        if outliers.size:
            print('Outlier chains found with following chainindices:\n')
            print(outliers.astype(float))
            lines = ['# Outlier chainindices with %.3f deviation '
                     'condition' % dev]
            lines += ['%d\t%.3f' % (c, s)
                      for c, s in zip(outliers, (1 - scores)[bad])]
            with open(op.join(self.datapath, 'outliers.dat'), 'w') as f:
                f.write('\n'.join(lines) + '\n')
        return outliers

    def convergence_report(self, ftypes=('likes', 'vpvs'), phase=2):
        """Split-R-hat + effective sample size over the stored
        per-chain traces (diagnostics.py) — positive convergence
        evidence to complement the outlier pruning.  Chains may have
        unequal lengths (the reference layout allows it); the common
        tail is used.  Returns {ftype: {'rhat':…, 'ess':…, …}}."""
        from bayhunter_jax import diagnostics
        traces = {}
        for ft in ftypes:
            rows = [np.atleast_1d(np.squeeze(
                        self.store.load(c, ft, phase)))
                    for c in self.store.chains]
            n = min(r.shape[0] for r in rows)
            traces[ft] = np.stack([r[-n:] for r in rows])
        rep = diagnostics.convergence_report(traces)
        for ft, d in rep.items():
            print('%s: split-R-hat %.4f, ESS %.0f (%.1f/chain)%s'
                  % (ft, d['rhat'], d['ess'], d['ess_per_chain'],
                     '' if d['converged'] else '  [NOT converged]'))
        return rep

    def save_final_distribution(self, maxmodels=200000, dev=0.05):
        """Pool the phase-2 chains (outliers excluded) into the final
        ``c_*.npy`` posterior, evenly subsampled to ``maxmodels``
        (reference: src/Plotting.py:161-262)."""
        stale = op.join(self.datapath, 'outliers.dat')
        if op.exists(stale):
            os.remove(stale)
        self.outliers = self.get_outliers(dev=dev)

        keep = [c for c in self.store.chains if c not in self.outliers]
        per_chain = int(maxmodels) // max(len(keep), 1)
        rng = np.random.RandomState(_SUBSAMPLE_SEED)

        pooled = {ft: [] for ft in FTYPES}
        for cidx in keep:
            nmod = len(self.store.load(cidx, 'likes'))
            if nmod > per_chain:
                pick = np.sort(rng.choice(np.arange(nmod), per_chain,
                                          replace=False))
            else:
                pick = np.arange(nmod)
            for ft in FTYPES:
                pooled[ft].append(self.store.load(cidx, ft)[pick])

        print('> Saving posterior distribution.')
        for ft in FTYPES:
            out = op.join(self.datapath, 'c_%s' % ft)
            np.save(out, np.concatenate(pooled[ft], axis=0))
            print(out)
        self.store._cache = {k: v for k, v in self.store._cache.items()
                             if k[0] != 'final'}

    # ------------------------------------------------------------ misc

    def savefig(self, fig, filename):
        if fig is None:
            return
        fig.savefig(op.join(self.figpath, filename),
                    bbox_inches='tight')
        if filename.startswith('c_') and filename.endswith('.pdf'):
            self._summary_append(fig)
        plt.close('all')

    def _summary_append(self, fig):
        if self._summary_pdf is None:
            from matplotlib.backends.backend_pdf import PdfPages
            self._summary_pdf = PdfPages(
                op.join(self.figpath, 'c_summary.pdf'))
        self._summary_pdf.savefig(fig, bbox_inches='tight')

    @tryexcept
    def plot_refmodel(self, fig, mtype='model', **kwargs):
        """Overlay the true/reference values on an existing figure."""
        ref = self.refmodel.get(mtype)
        if fig is None or ref is None:
            return fig
        if mtype == 'model':
            dep, vs = ref
            fig.axes[0].plot(vs, dep, **kwargs)
            if len(fig.axes) == 2:
                for d in np.unique(dep):
                    fig.axes[1].axhline(d, **kwargs)
        elif mtype == 'noise':
            for ax, val in zip(fig.axes, ref):
                ax.axvline(val, color='red', lw=0.5, alpha=0.7)
        else:  # scalar markers: nlays, vpvs
            fig.axes[0].axvline(ref, color='red', lw=0.5, alpha=0.7)
        return fig

    # ----------------------------------------------- iteration traces

    def _trace_series(self, cidx, ftype, reduce):
        """Per-phase (iterations, values) for one chain's trace."""
        out = []
        for phase, lo, hi in ((1, -self.initparams['iter_burnin'], 0),
                              (2, 0, self.initparams['iter_main'])):
            vals = reduce(self.store.load(cidx, ftype, phase))
            out.append((np.linspace(lo, hi, vals.size), vals, phase))
        return out

    def _plot_traces(self, ftype, nchains, reduce, ylabel):
        """Burn-in + main traces of ``ftype`` for the first chains."""
        fig, ax = plt.subplots(figsize=(7, 4))
        chains = self.store.chains[:nchains]
        colors = _rainbow(len(chains))
        lo = -self.initparams['iter_burnin']
        hi = self.initparams['iter_main']

        ymin, ymax = np.inf, -np.inf
        for color, cidx in zip(colors, chains):
            for its, vals, phase in self._trace_series(cidx, ftype,
                                                       reduce):
                main = phase == 2
                ax.plot(its, vals, color=color,
                        lw=0.8 if main else 0.5,
                        alpha=0.7 if main else 0.4,
                        label='c%d' % cidx if main else '')
                if main:
                    ymin = min(ymin, vals.min())
                    ymax = max(ymax, vals.max())

        ax.axvline(0, color='k', ls=':', alpha=0.7)
        ax.set_xlim(lo, hi)
        ax.set_ylim(ymin * 0.95, ymax * 1.05)
        span = hi - lo
        ax.text(-lo / 2 / span, 0.97, 'Burn-in phase', fontsize=12,
                ha='center', va='top', transform=ax.transAxes)
        ax.text((-lo + hi / 2) / span, 0.97, 'Exploration phase',
                fontsize=12, ha='center', va='top',
                transform=ax.transAxes)
        ax.set_xlabel('# Iteration')
        ax.set_ylabel(ylabel)
        ax.legend(loc='center left', bbox_to_anchor=(1, 0.5))
        return fig

    @tryexcept
    def plot_iiterlikes(self, nchains=6):
        return self._plot_traces('likes', nchains, lambda a: a,
                                 'Likelihood')

    @tryexcept
    def plot_iitermisfits(self, nchains=6, ind=-1):
        return self._plot_traces('misfits', nchains,
                                 lambda a: a.T[ind],
                                 '%s misfit' % self.refs[ind])

    @tryexcept
    def plot_iiternoise(self, nchains=6, ind=-1):
        return self._plot_traces('noise', nchains, lambda a: a.T[ind],
                                 self._noise_labels()[ind])

    @tryexcept
    def plot_iiternlayers(self, nchains=6):
        return self._plot_traces(
            'models', nchains,
            lambda a: np.isfinite(a).sum(axis=1) / 2 - 1,
            'Number of layers')

    @tryexcept
    def plot_iitervpvs(self, nchains=6):
        return self._plot_traces('vpvs', nchains, lambda a: a,
                                 'Vp / Vs')

    def _noise_labels(self):
        labels = []
        for ref in self.refs[:-1]:
            labels += ['correlation (%s)' % ref, r'$\sigma$ (%s)' % ref]
        return labels

    # ------------------------------------------------------ posteriors

    def _posterior(self, ftype, final, chainidx):
        if final:
            return self.store.final(ftype)
        return self.store.load(chainidx, ftype)

    def _get_posterior_data(self, data, final, chainidx=0):
        # reference-compatible helper signature
        return [self._posterior(ft, final, chainidx) for ft in data]

    @tryexcept
    def plot_posterior_likes(self, final=True, chainidx=0):
        fig, ax = plt.subplots(figsize=(3.5, 3))
        _hist_panel(ax, self._posterior('likes', final, chainidx), 20,
                    '%d')
        ax.set_xlabel('Likelihood')
        return fig

    @tryexcept
    def plot_posterior_misfits(self, final=True, chainidx=0):
        per_target = self._posterior('misfits', final, chainidx).T[:-1]
        k = len(per_target)
        fig, axes = plt.subplots(1, k, figsize=(3.5 * k, 3),
                                 squeeze=False)
        for ax, vals, ref in zip(axes[0], per_target, self.refs):
            _hist_panel(ax, vals, 20, '%.2f')
            ax.set_xlabel('RMS misfit (%s)' % ref)
        return fig

    @tryexcept
    def plot_posterior_nlayers(self, final=True, chainidx=0):
        models = self._posterior('models', final, chainidx)
        layers = np.isfinite(models).sum(axis=1) / 2 - 1
        fig, ax = plt.subplots(figsize=(3.5, 3))
        _hist_panel(ax, layers, _nlayer_bins(layers), '%d')
        ticks = np.arange(int(layers.min()), int(layers.max()) + 1)
        ax.set_xticks(ticks)
        ax.set_xticklabels(ticks)
        ax.set_xlabel('Number of layers')
        return fig

    @tryexcept
    def plot_posterior_vpvs(self, final=True, chainidx=0):
        fig, ax = plt.subplots(figsize=(3.5, 3))
        _hist_panel(ax, self._posterior('vpvs', final, chainidx), 20,
                    '%.2f')
        ax.set_xlabel('$V_P$ / $V_S$')
        return fig

    @tryexcept
    def plot_posterior_noise(self, final=True, chainidx=0):
        noise = self._posterior('noise', final, chainidx)
        labels = self._noise_labels()
        rows = noise.shape[1] // 2
        fig, axes = plt.subplots(rows, 2, figsize=(7, 3 * rows),
                                 squeeze=False)
        fig.subplots_adjust(hspace=0.2)
        for i, vals in enumerate(noise.T):
            ax = axes[i // 2][i % 2]
            if np.ptp(vals) == 0:
                _constant_panel(ax, vals[0])
            else:
                _hist_panel(ax, vals, 20, '%.4f')
            ax.set_xlabel(labels[i])
        return fig

    @tryexcept
    def plot_posterior_others(self, final=True, chainidx=0):
        """Likelihood / joint misfit / vpvs / nlayers in one figure."""
        likes = self._posterior('likes', final, chainidx)
        joint = self._posterior('misfits', final, chainidx).T[-1]
        vpvs = self._posterior('vpvs', final, chainidx)
        models = self._posterior('models', final, chainidx)
        layers = np.isfinite(models).sum(axis=1) / 2 - 1

        fig, axes = plt.subplots(2, 2, figsize=(7, 6))
        panels = [(likes, 20, '%d', 'Likelihood'),
                  (joint, 20, '%.2f', 'Joint misfit'),
                  (vpvs, 20, '%.2f', '$V_P$ / $V_S$'),
                  (layers, _nlayer_bins(layers), '%d',
                   'Number of layers')]
        for ax, (vals, bins, fmt, label) in zip(axes.ravel(), panels):
            if label.startswith('$V_P$') and np.ptp(vals) == 0:
                _constant_panel(ax, vals[0])
            else:
                _hist_panel(ax, vals, bins, fmt)
            ax.set_xlabel(label)
        return fig

    def _depth_grid(self, depint):
        zmin, zmax = self.priors['z']
        return np.arange(zmin, zmax + depint, depint)

    @tryexcept
    def plot_posterior_models1d(self, final=True, chainidx=0, depint=1):
        models = self._posterior('models', final, chainidx)
        nch = (self.initparams['nchains'] - self.outliers.size
               if final else 1)
        summary = ModelMatrix.get_singlemodels(
            models, self._depth_grid(depint))

        fig, ax = plt.subplots(figsize=(4.4, 7))
        for name, color, style in (('mean', 'green', '-'),
                                   ('median', 'blue', '--'),
                                   ('stdminmax', 'black', ':')):
            vs, dep = summary[name]
            ax.plot(np.atleast_2d(vs).T, dep, color=color, ls=style,
                    lw=1, label=name)
        handles, names = ax.get_legend_handles_labels()
        ax.legend(handles[:-1], names[:-1], loc=3)
        ax.set_ylim(self.priors['z'][::-1])
        ax.set_xlabel('$V_S$ in km/s')
        ax.set_ylabel('Depth in km')
        ax.grid(color='gray', alpha=0.6, ls=':', lw=0.5)
        ax.set_title('%d models from %d chains' % (len(models), nch))
        return fig

    @tryexcept
    def plot_posterior_models2d(self, final=True, chainidx=0, depint=1):
        """2-D vs-depth density + interface-depth histogram + mode
        profile (reference: src/Plotting.py:462-536, 625-641)."""
        models = self._posterior('models', final, chainidx)
        nch = (self.initparams['nchains'] - self.outliers.size
               if final else 1)

        grid = self._depth_grid(depint)
        fine = np.arange(grid[0], grid[-1] + depint / 2., depint / 2.)
        vss, deps = ModelMatrix.get_interpmodels(models, fine)

        # interface depths from the thickness representation
        vsh = ModelMatrix._replace_zvnoi_h(models)
        half = vsh.shape[1] // 2
        ifaces = []
        for row in vsh:
            h = row[half:][np.isfinite(row[half:])]
            ifaces.append(np.cumsum(h[:-1]))
        ifaces = np.concatenate(ifaces) if ifaces else np.zeros(0)

        vlo = vs_round(vss.min()) - 0.05
        vhi = vs_round(vss.max()) + 0.075
        vbins = np.arange(vlo, vhi, 0.025)
        density, ve, de = np.histogram2d(vss.ravel(), deps.ravel(),
                                         bins=(vbins, grid))

        fig, axes = plt.subplots(
            1, 2, gridspec_kw={'width_ratios': [4, 1]}, sharey=True,
            figsize=(5, 6.5))
        fig.subplots_adjust(wspace=0.05)
        axes[0].imshow(density.T, origin='lower', aspect='auto',
                       extent=(ve[0], ve[-1], de[0], de[-1]),
                       vmax=len(models))
        mode_vs, mode_dep = ModelMatrix.get_singlemodels(
            models, dep_int=grid)['mode']
        axes[0].plot(mode_vs, mode_dep, color='white', lw=1, alpha=0.9,
                     label='mode')
        axes[0].legend(loc=3)
        axes[1].hist(ifaces, bins=grid, orientation='horizontal',
                     color='lightgray', alpha=0.7, edgecolor='k')
        axes[1].set_xticks([])
        axes[0].set_xlabel('$V_S$ in km/s')
        axes[0].set_ylabel('Depth in km')
        axes[0].set_ylim(self.priors['z'][::-1])
        axes[0].set_title('%d models from %d chains'
                          % (len(models), nch))
        return fig

    # ---------------------------------------------- moho-crust tradeoff

    def _crust_moho_stats(self, models, vpvs, moho_range, mohovs):
        """Per-model (moho depth, mean crustal vs, last crustal vs,
        vs jump); NaN where no Moho qualifies."""
        out = np.full((len(models), 4), np.nan)
        for i, model in enumerate(models):
            vp, vs, h = Model.get_vp_vs_h(model, vpvs[i], self.mantle)
            bottoms = np.cumsum(h)
            in_range = (bottoms > moho_range[0]) \
                & (bottoms < moho_range[1])
            fast_below = np.zeros_like(in_range)
            fast_idx = np.where(vs > mohovs)[0] - 1
            fast_below[fast_idx[(fast_idx >= 0)
                                & (fast_idx < len(h))]] = True
            cand = np.where(in_range & fast_below)[0]
            if cand.size == 0:
                continue
            k = cand[0]
            out[i] = (bottoms[k],
                      np.dot(vs[:k + 1], h[:k + 1]) / bottoms[k],
                      vs[k],
                      np.diff(vs)[k] if k < vs.size - 1 else np.nan)
        return out[np.isfinite(out[:, 3])]

    @tryexcept
    def plot_moho_crustvel_tradeoff(self, moho=None, mohovs=None,
                                    refmodel=None):
        """Moho depth vs crustal-velocity tradeoff
        (reference: src/Plotting.py:753-902)."""
        models = self.store.final('models')
        vpvs = self.store.final('vpvs')
        moho = moho if moho is not None else self.priors['z']
        mohovs = mohovs if mohovs is not None else 4.2

        stats = self._crust_moho_stats(models, vpvs, moho, mohovs)
        mohos, vscrust, vslast, vsjump = stats.T
        columns = [vslast, vscrust, vsjump]
        labels = ['$V_S$ last crustal layer', '$V_S$ crustal mean',
                  '$V_S$ increase']
        nbins = 50

        fig, ax = plt.subplots(2, 4, figsize=(11, 6))
        fig.subplots_adjust(hspace=0.05, wspace=0.05)

        for col, (vals, label) in enumerate(zip(columns, labels)):
            top, bottom = ax[0][col], ax[1][col]
            top.hist(vals, bins=nbins, color='darkblue', alpha=0.7,
                     edgecolor='white', linewidth=0.4)
            med = np.median(vals)
            top.axvline(med, color='k', ls='--', lw=1.2)
            top.text(0.97, 0.97, 'median:\n%.2f km/s' % med,
                     fontsize=9, color='k', ha='right', va='top',
                     transform=top.transAxes)
            density, xe, ye, _ = bottom.hist2d(vals, mohos, bins=nbins)
            xi, yi = np.unravel_index(density.argmax(), density.shape)
            bottom.axvline(0.5 * (xe[xi] + xe[xi + 1]), color='white',
                           ls='--', lw=0.5, alpha=0.7)
            bottom.axhline(0.5 * (ye[yi] + ye[yi + 1]), color='white',
                           ls='--', lw=0.5, alpha=0.7)
            bottom.set_xlabel(label)
            top.set_xlim(bottom.get_xlim())
            top.set_yticks([])
            top.set_xticklabels([], visible=False)

        med_moho = np.median(mohos)
        print('moho: %.4f +- %.4f km' % (med_moho, np.std(mohos)))
        ax[1][3].hist(mohos, bins=nbins, orientation='horizontal',
                      color='darkblue', alpha=0.7, edgecolor='white',
                      linewidth=0.4)
        ax[1][3].axhline(med_moho, color='k', ls='--', lw=1.2)
        ax[1][3].text(0.97, 0.97, 'median:\n%.2f km' % med_moho,
                      fontsize=9, color='k', ha='right', va='top',
                      transform=ax[1][3].transAxes)
        ax[1][3].set_xticklabels([], visible=False)
        ax[1][3].set_yticks([])
        ax[0][3].axis('off')
        ax[1][0].set_ylabel('Moho depth in km')
        for col in (1, 2, 3):
            ax[1][col].set_yticklabels([], visible=False)
        ylims = ax[1][0].get_ylim()
        for col in range(4):
            ax[1][col].set_ylim(ylims)

        if refmodel is not None:
            dep, vs = refmodel
            h = (dep[1:] - dep[:-1])[::2]
            bottoms, lvs = dep[1::2], vs[::2]
            steps = np.diff(lvs)
            in_range = np.where((bottoms > moho[0])
                                & (bottoms < moho[1]))[0]
            k = in_range[np.argmax(steps[in_range])]
            truths = [lvs[k],
                      np.dot(lvs[:k + 1], h[:k + 1]) / bottoms[k],
                      steps[k]]
            for col, val in enumerate(truths):
                ax[1][col].axhline(bottoms[k], color='red', ls='--',
                                   lw=0.5, alpha=0.7)
                ax[1][col].axvline(val, color='red', ls='--', lw=0.5,
                                   alpha=0.7)
        return fig

    # ---------------------------------------- current/best model views

    def _latest_state(self, cidx):
        models = self.store.load(cidx, 'models')
        vpvs = self.store.load(cidx, 'vpvs')
        return models[-1], np.atleast_1d(vpvs)[-1]

    def _best_state(self, cidx):
        joint = self.store.load(cidx, 'misfits').T[-1]
        k = int(np.argmin(joint))
        return (self.store.load(cidx, 'models')[k],
                np.atleast_1d(self.store.load(cidx, 'vpvs'))[k])

    def _profile_axes(self, title):
        fig, ax = plt.subplots(figsize=(4, 6.5))
        ax.set_xlabel('$V_S$ in km/s')
        ax.set_ylabel('Depth in km')
        ax.set_ylim(self.priors['z'][::-1])
        ax.set_title(title)
        ax.grid(color='gray', alpha=0.6, ls=':', lw=0.5)
        return fig, ax

    @tryexcept
    def plot_currentmodels(self, nchains):
        """Latest model per chain (reference: src/Plotting.py:907-940)."""
        chains = self.store.chains[:nchains]
        fig, ax = self._profile_axes('Current models')
        for color, cidx in zip(_rainbow(len(chains)), chains):
            model, vpvs = self._latest_state(cidx)
            vs_step, dep_step, (vp, vs, h) = _profile_from_vector(
                model, vpvs, self.mantle)
            ax.plot(vs_step, dep_step, color=color, lw=0.8, alpha=0.7,
                    label='c%d / %d' % (cidx, vs.size - 1))
        ax.legend(loc='center left', bbox_to_anchor=(1, 0.5))
        return fig

    @tryexcept
    def plot_bestmodels(self):
        """Best model per non-outlier chain
        (reference: src/Plotting.py:1000-1051)."""
        chains = [c for c in self.store.chains
                  if c not in self.outliers]
        fig, ax = self._profile_axes(
            'Best fit models from %d chains' % len(chains))
        for cidx in chains:
            model, vpvs = self._best_state(cidx)
            vs_step, dep_step, _ = _profile_from_vector(model, vpvs,
                                                        self.mantle)
            ax.plot(vs_step, dep_step, color='k', lw=0.8, alpha=0.5)
        return fig

    def _overlay_datafits(self, picks, title, labeled=True):
        """Observed data axes + forward-modeled fits of given states.

        ``picks`` yields (chainidx, model, vpvs) triples.
        """
        joint = Targets.JointTarget(targets=self.targets)
        fig, axes = joint.plot_obsdata(mod=False)
        axlist = axes if isinstance(axes, (list, np.ndarray)) \
            else [axes]
        colors = _rainbow(len(picks))

        for color, (cidx, model, vpvs) in zip(colors, picks):
            vp, vs, h = Model.get_vp_vs_h(model, vpvs, self.mantle)
            rho = vp * 0.32 + 0.77
            total_rms = 0.0
            for n, target in enumerate(joint.targets):
                xm, ym = target.moddata.plugin.run_model(
                    h=h, vp=vp, vs=vs, rho=rho)
                total_rms += target.valuation.get_rms(
                    target.obsdata.y, ym)
                last = n == len(joint.targets) - 1
                axlist[n].plot(
                    xm, ym, alpha=0.7, lw=0.8,
                    color=color if labeled else 'k',
                    label=('c%d / %.3f' % (cidx, total_rms)
                           if last and labeled else ''))

        axlist[0].set_title(title)
        if labeled:
            h_, l_ = axlist[-1].get_legend_handles_labels()
            seen = dict(zip(l_, h_))
            fig.legend(seen.values(), seen.keys(), loc='center left',
                       bbox_to_anchor=(0.92, 0.5))
        leg = axlist[0].get_legend()
        if leg is not None and labeled:
            leg.set_visible(False)
        return fig

    @tryexcept
    def plot_currentdatafits(self, nchains):
        """Latest data fit per chain
        (reference: src/Plotting.py:942-997)."""
        picks = [(c,) + self._latest_state(c)
                 for c in self.store.chains[:nchains]]
        return self._overlay_datafits(picks, 'Current data fits')

    @tryexcept
    def plot_bestdatafits(self):
        """Best data fit per non-outlier chain
        (reference: src/Plotting.py:1053-1111)."""
        picks = [(c,) + self._best_state(c)
                 for c in self.store.chains if c not in self.outliers]
        return self._overlay_datafits(
            picks, 'Best data fits from %d chains' % len(picks),
            labeled=False)

    @tryexcept
    def plot_rfcorr(self, rf='prf'):
        """Best-model RF residual against a realization of the
        inferred correlated noise (reference: src/Plotting.py:1114-1151).
        """
        from bayhunter_jax.synthobs import SynthObs

        idx = self.refs.index(rf)
        misfits = self.store.final('misfits').T[idx]
        best = int(np.argmin(misfits))
        model = self.store.final('models')[best]
        vpvs = self.store.final('vpvs')[best]
        corr, sigma = self.store.final('noise')[best][2 * idx:
                                                      2 * idx + 2]

        target = self.targets[idx]
        x, y = target.obsdata.x, target.obsdata.y
        vp, vs, h = Model.get_vp_vs_h(model, vpvs, self.mantle)
        _, ymod = target.moddata.plugin.run_model(
            h=h, vp=vp, vs=vs, rho=vp * 0.32 + 0.77)

        fig, axes = plt.subplots(2, sharex=True, sharey=True)
        axes[0].plot(x, y - ymod, color='k', lw=0.7, label='residuals')
        axes[1].plot(x, SynthObs.compute_gaussnoise(y, corr=corr,
                                                    sigma=sigma),
                     color='k', lw=0.7, label='noise realization')
        for ax in axes:
            ax.legend(loc=4)
            ax.grid(color='gray', ls=':', lw=0.5)
        axes[0].set_xlim(x[0], x[-1])
        axes[1].set_xlabel('Time in s')
        return fig

    # ---------------------------------------------------------- drivers

    def merge_pdfs(self):
        """Combine the c_*.pdf figures into c_summary.pdf
        (reference: src/Plotting.py:1153-1170)."""
        target = op.join(self.figpath, 'c_summary.pdf')
        try:
            from pypdf import PdfReader, PdfWriter
        except ImportError:
            try:
                from PyPDF2 import PdfReader, PdfWriter
            except ImportError:
                if self._summary_pdf is not None:
                    self._summary_pdf.close()
                    self._summary_pdf = None
                    print('Saved summary: %s' % target)
                return

        writer = PdfWriter()
        parts = sorted(glob.glob(op.join(self.figpath, 'c_*.pdf')),
                       key=op.getmtime)
        for part in parts:
            if op.abspath(part) == op.abspath(target):
                continue
            for page in PdfReader(part).pages:
                writer.add_page(page)
        with open(target, 'wb') as f:
            writer.write(f)

    def save_chainplots(self, cidx=0, refmodel=dict(), depint=None):
        """Per-chain posterior figures
        (reference: src/Plotting.py:1172-1207)."""
        self.refmodel.update(refmodel)
        depint = depint or 1
        jobs = [
            (self.plot_posterior_misfits(final=False, chainidx=cidx),
             None, 'posterior_misfit'),
            (self.plot_posterior_nlayers(final=False, chainidx=cidx),
             'nlays', 'posterior_nlayers'),
            (self.plot_posterior_noise(final=False, chainidx=cidx),
             'noise', 'posterior_noise'),
            (self.plot_posterior_models1d(final=False, chainidx=cidx,
                                          depint=depint),
             ('model', dict(color='k', lw=1)), 'posterior_models1d'),
            (self.plot_posterior_models2d(final=False, chainidx=cidx,
                                          depint=depint),
             ('model', dict(color='red', lw=0.5, alpha=0.7)),
             'posterior_models2d'),
        ]
        for fig, overlay, name in jobs:
            self._overlay_and_save(fig, overlay,
                                   'c%.3d_%s.pdf' % (cidx, name))

    def _overlay_and_save(self, fig, overlay, filename):
        if overlay is not None:
            if isinstance(overlay, tuple):
                mtype, kwargs = overlay
                self.plot_refmodel(fig, mtype, **kwargs)
            else:
                self.plot_refmodel(fig, overlay)
        self.savefig(fig, filename)

    def save_plots(self, nchains=5, refmodel=dict(), depint=1):
        """The standard figure report
        (reference: src/Plotting.py:1209-1271)."""
        self.refmodel.update(refmodel)
        nchains = int(min(nchains, len(self.store.chains)))

        self.savefig(self.plot_iiterlikes(nchains=nchains),
                     'c_iiter_likes.pdf')
        self.savefig(self.plot_iitermisfits(nchains=nchains, ind=-1),
                     'c_iiter_misfits.pdf')
        self.savefig(self.plot_iiternlayers(nchains=nchains),
                     'c_iiter_nlayers.pdf')
        self.savefig(self.plot_iitervpvs(nchains=nchains),
                     'c_iiter_vpvs.pdf')
        for i in range(self.ntargets):
            ind = i * 2 + 1
            self.savefig(self.plot_iiternoise(nchains=nchains, ind=ind),
                         'c_iiter_noisepar%d.pdf' % ind)

        self._overlay_and_save(self.plot_currentmodels(nchains),
                               ('model', dict(color='k', lw=1)),
                               'c_currentmodels.pdf')
        self.savefig(self.plot_currentdatafits(nchains),
                     'c_currentdatafits.pdf')

        self._overlay_and_save(self.plot_posterior_nlayers(), 'nlays',
                               'c_posterior_nlayers.pdf')
        self._overlay_and_save(self.plot_posterior_vpvs(), 'vpvs',
                               'c_posterior_vpvs.pdf')
        self._overlay_and_save(self.plot_posterior_noise(), 'noise',
                               'c_posterior_noise.pdf')
        self._overlay_and_save(self.plot_posterior_models1d(
            depint=depint), ('model', dict(color='k', lw=1)),
            'c_posterior_models1d.pdf')
        self._overlay_and_save(self.plot_posterior_models2d(
            depint=depint),
            ('model', dict(color='red', lw=0.5, alpha=0.7)),
            'c_posterior_models2d.pdf')
