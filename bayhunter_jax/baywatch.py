"""BayWatch — live inversion monitoring client.

Port of the reference BayWatch (reference: src/BayWatch.py): a ZMQ SUB
client that receives the three telemetry arrays published by the
optimizer — [vpvs | model], likes, noise — keeps rolling buffers per
chain, and renders a live matplotlib view: current velocity-depth
models, data fits (recomputed client-side with the forward plugins),
likelihood and noise traces, and vp/vs strip, with chain prev/next
buttons.  The wire format is byte-compatible with the reference
(JSON header {dtype, shape} + raw buffer; src/utils.py:20-41), so this
client can watch a reference inversion and vice versa.
"""

import argparse
import logging
import time

import numpy as np

from bayhunter_jax import utils
from bayhunter_jax.models import Model

logger = logging.getLogger(__name__)


class BayWatcher(object):
    """Live monitor (reference: src/BayWatch.py:31-594)."""

    def __init__(self, configfile=None, capacity=100, address='127.0.0.1',
                 port=5556, save_plots=None):
        """``save_plots``: optional path template (e.g.
        ``/path/fig{count:04d}.png``) — every plot update is also saved
        there, like the reference CLI's --save-plots
        (reference: src/BayWatch.py:616-618)."""
        import zmq

        if configfile is None:
            configfile = 'baywatch.pkl'
        condict = utils.read_config(configfile)
        self.targets = condict['targets']
        self.priors = condict['priors']
        self.initparams = condict['initparams']
        self.refmodel = condict.get('refmodel', {})

        self.capacity = capacity
        self.mantle = self.priors.get('mantle', None)

        context = utils.SerializingContext()
        self.socket = context.socket(zmq.SUB)
        self.socket.connect('tcp://%s:%d' % (address, port))
        self.socket.setsockopt(zmq.SUBSCRIBE, b'')
        logger.info('Connected to tcp://%s:%d' % (address, port))

        self.vpvs = self.priors['vpvs']
        self.nchains = self.initparams['nchains']
        maxlayers = int(self.priors['layers'][1]) + 1
        self.modellength = maxlayers * 2
        self.ntargets = len(self.targets)

        self.chainidx = 0
        self.capacity_reached = False
        if save_plots:
            import os.path as op
            outdir = op.dirname(save_plots)
            if outdir and not op.isdir(outdir):
                # fail fast like the reference (src/BayWatch.py:42-43)
                raise OSError('save_plots directory does not exist: '
                              '%s' % outdir)
            # fail fast on a malformed template too — a stray brace
            # would otherwise raise mid-watch, hours into a run
            try:
                p0 = save_plots.format(count=0)
                p1 = save_plots.format(count=1)
            except (KeyError, IndexError, ValueError) as e:
                raise ValueError(
                    'save_plots template %r is not formattable with '
                    'count= (%s)' % (save_plots, e))
            if p0 == p1:
                logger.warning(
                    'save_plots template %r has no {count} field — '
                    'every update will overwrite the same file.'
                    % save_plots)
        self.save_plots = save_plots
        self._save_count = 0

        self.modelbuffer = {}   # chain -> list of (vpvs, model)
        self.likebuffer = {}    # chain -> list of likes
        self.noisebuffer = {}   # chain -> list of noise vectors
        self._laststate = None
        self._stable_count = 0

    # -------------------------------------------------------- data intake

    def store_data(self, arr):
        """Dispatch a received array on its shape
        (reference: src/BayWatch.py:421-483, 549-567)."""
        ncol = arr.shape[-1] if arr.ndim == 2 else 1
        if ncol == 1:
            self._store(self.likebuffer, arr.reshape(-1, 1))
            return 'likes'
        elif ncol == self.modellength + 1:
            self._store(self.modelbuffer, arr)
            return 'models'
        elif ncol % 2 == 0:
            self._store(self.noisebuffer, arr)
            return 'noise'
        return None

    def _store(self, buffer, arr):
        for ic in range(arr.shape[0]):
            buffer.setdefault(ic, [])
            buffer[ic].append(np.array(arr[ic]))
            if len(buffer[ic]) > self.capacity:
                buffer[ic].pop(0)

    def check_convergence(self):
        """End-of-inversion heuristic: all chains frozen
        (reference: src/BayWatch.py:432-444)."""
        state = tuple(
            tuple(self.likebuffer[c][-1]) for c in
            sorted(self.likebuffer)) if self.likebuffer else None
        if state is not None and state == self._laststate:
            self._stable_count += 1
        else:
            self._stable_count = 0
        self._laststate = state
        return self._stable_count > 10

    # ----------------------------------------------------------- plotting

    def init_plot(self):
        import matplotlib.pyplot as plt
        from matplotlib.widgets import Button

        self.plt = plt
        plt.ion()
        self.fig = plt.figure(figsize=(12, 7))
        gs = self.fig.add_gridspec(2 + self.ntargets, 3)
        self.ax_model = self.fig.add_subplot(gs[:, 0])
        self.ax_targets = [self.fig.add_subplot(gs[i, 1])
                           for i in range(self.ntargets)]
        self.ax_like = self.fig.add_subplot(gs[self.ntargets, 1]) \
            if self.ntargets < 2 + self.ntargets else None
        self.ax_like = self.fig.add_subplot(gs[0, 2])
        self.ax_noise = self.fig.add_subplot(gs[1, 2])

        self.ax_model.set_xlabel('$V_S$ in km/s')
        self.ax_model.set_ylabel('Depth in km')
        self.ax_model.set_ylim(self.priors['z'][::-1])
        self.ax_model.set_xlim(self.priors['vs'])

        for i, target in enumerate(self.targets):
            self.ax_targets[i].plot(target.obsdata.x, target.obsdata.y,
                                    'k.', ms=2, label=target.ref)
            self.ax_targets[i].legend(loc=1, fontsize=7)

        self.ax_like.set_ylabel('Likelihood')
        self.ax_noise.set_ylabel(r'$\sigma$')

        if self.refmodel.get('explike') is not None:
            self.ax_like.axhline(self.refmodel['explike'], color='red',
                                 lw=0.7, alpha=0.7)
        if self.refmodel.get('model') is not None:
            dep, vs = self.refmodel['model']
            self.ax_model.plot(vs, dep, color='red', lw=0.8, alpha=0.8)

        ax_prev = self.fig.add_axes([0.78, 0.02, 0.08, 0.04])
        ax_next = self.fig.add_axes([0.88, 0.02, 0.08, 0.04])
        self.b_prev = Button(ax_prev, 'prev chain')
        self.b_next = Button(ax_next, 'next chain')
        self.b_prev.on_clicked(self._prev_chain)
        self.b_next.on_clicked(self._next_chain)
        self._model_lines = []
        self._fit_lines = []

    def _prev_chain(self, _event):
        self.chainidx = (self.chainidx - 1) % max(self.nchains, 1)

    def _next_chain(self, _event):
        self.chainidx = (self.chainidx + 1) % max(self.nchains, 1)

    def compute_synth(self, model, vpvs):
        """Client-side forward solve for the data-fit panel
        (reference: src/BayWatch.py:390-408)."""
        model = model[~np.isnan(model)]
        try:
            vp, vs, h = Model.get_vp_vs_h(model, vpvs, self.mantle)
            rho = vp * 0.32 + 0.77
            fits = []
            for target in self.targets:
                xmod, ymod = target.moddata.plugin.run_model(
                    h=h, vp=vp, vs=vs, rho=rho)
                fits.append((xmod, ymod))
            return fits
        except Exception:
            return None

    def update_plot(self):
        ic = self.chainidx
        if ic not in self.modelbuffer or not self.modelbuffer[ic]:
            return

        for ln in self._model_lines + self._fit_lines:
            try:
                ln.remove()
            except Exception:
                pass
        self._model_lines = []
        self._fit_lines = []

        rows = self.modelbuffer[ic]
        nshow = len(rows)
        for i, row in enumerate(rows):
            vpvs, model = row[0], row[1:]
            model = model[~np.isnan(model)]
            if model.size < 4:
                continue
            try:
                vp, vs, h = Model.get_vp_vs_h(model, vpvs, self.mantle)
                cvp, cvs, cdep = Model.get_stepmodel_from_h(h=h, vs=vs,
                                                            vp=vp)
                alpha = 0.15 + 0.85 * (i + 1) / nshow
                color = 'k' if i < nshow - 1 else 'red'
                ln, = self.ax_model.plot(cvs, cdep, color=color,
                                         lw=0.6, alpha=alpha)
                self._model_lines.append(ln)
            except Exception:
                continue

        # latest data fit
        vpvs, model = rows[-1][0], rows[-1][1:]
        fits = self.compute_synth(model, vpvs)
        if fits is not None:
            for i, (xmod, ymod) in enumerate(fits):
                ln, = self.ax_targets[i].plot(xmod, ymod, color='red',
                                              lw=0.8, alpha=0.8)
                self._fit_lines.append(ln)

        # likelihood trace
        if ic in self.likebuffer:
            likes = np.array(self.likebuffer[ic]).flatten()
            self.ax_like.clear()
            self.ax_like.plot(likes, color='k', lw=0.7)
            if self.refmodel.get('explike') is not None:
                self.ax_like.axhline(self.refmodel['explike'],
                                     color='red', lw=0.7, alpha=0.7)
            self.ax_like.set_ylabel('Likelihood (c%d)' % ic)

        # sigma traces
        if ic in self.noisebuffer:
            noise = np.array(self.noisebuffer[ic])
            self.ax_noise.clear()
            for t in range(noise.shape[1] // 2):
                self.ax_noise.plot(noise[:, 2 * t + 1], lw=0.7,
                                   label=r'$\sigma_{%d}$' % t)
            self.ax_noise.legend(loc=1, fontsize=7)

        self.ax_model.set_title('chain %d' % ic)
        self.fig.canvas.draw_idle()
        self.fig.canvas.flush_events()

    # -------------------------------------------------------------- main

    def watch(self, plot=True, timeout=None):
        """Receive loop (reference: src/BayWatch.py:539-594)."""
        import zmq

        if plot:
            self.init_plot()

        poller = zmq.Poller()
        poller.register(self.socket, zmq.POLLIN)
        t0 = time.time()
        while True:
            socks = dict(poller.poll(500))
            if self.socket in socks:
                arr = self.socket.recv_array()
                kind = self.store_data(arr)
                if plot and kind == 'noise':
                    # noise arrives last in each publish triple
                    self.update_plot()
                    if self.save_plots:
                        self.fig.savefig(self.save_plots.format(
                            count=self._save_count))
                        self._save_count += 1
            else:
                if self.check_convergence():
                    logger.info('Inversion finished (chains frozen).')
                    break
            if timeout is not None and (time.time() - t0) > timeout:
                break
        if plot:
            self.plt.ioff()


def main(args=None):
    parser = argparse.ArgumentParser(
        description='BayWatch — watch a running bayhunter_jax '
                    'inversion live.')
    parser.add_argument('path', nargs='?', default='.',
                        help='folder containing baywatch.pkl (or the '
                             'pkl file itself)')
    parser.add_argument('--address', default='127.0.0.1')
    parser.add_argument('--port', type=int, default=5556)
    parser.add_argument('--capacity', type=int, default=100)
    parser.add_argument('--save-plots', default=None, type=str,
                        help='path template to save plots, e.g. '
                             '/path/to/plots/fig{count:04d}.png')
    opts = parser.parse_args(args)

    import os.path as op
    configfile = opts.path
    if op.isdir(configfile):
        configfile = op.join(configfile, 'baywatch.pkl')

    logging.basicConfig(level=logging.INFO)
    watcher = BayWatcher(configfile, capacity=opts.capacity,
                         address=opts.address, port=opts.port,
                         save_plots=opts.save_plots)
    watcher.watch()


if __name__ == '__main__':
    main()
