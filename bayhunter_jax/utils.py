"""Utility module with reference-compatible surface
(reference: src/utils.py): config loading/saving (re-exported from
config.py), the ZMQ numpy-array socket used by the BayWatch live
stream, and the r_RF noise-correlation estimation tools.
"""

import numpy as np

from bayhunter_jax.config import (load_params, load_params_user,  # noqa: F401
                                  save_baywatch_config, save_config,
                                  read_config, get_path)

rstate = np.random.RandomState(333)


# ----------------------------------------------------------------------
# ZMQ serializing sockets (reference: src/utils.py:20-41)
# Wire format: JSON header {dtype, shape} + raw buffer — kept
# byte-compatible so the reference BayWatch client can connect.
# ----------------------------------------------------------------------

try:
    import zmq

    class SerializingSocket(zmq.Socket):
        """Socket with numpy-array send/recv carrying reconstruction
        metadata (dtype, shape)."""

        def send_array(self, arr, flags=0, copy=True, track=False):
            md = dict(dtype=str(arr.dtype), shape=arr.shape)
            self.send_json(md, flags | zmq.SNDMORE)
            return self.send(arr, flags, copy=copy, track=track)

        def recv_array(self, flags=0, copy=True, track=False):
            md = self.recv_json(flags=flags)
            msg = self.recv(flags=flags, copy=copy, track=track)
            arr = np.frombuffer(msg, dtype=md['dtype'])
            return arr.reshape(md['shape'])

    class SerializingContext(zmq.Context):
        _socket_class = SerializingSocket

except ImportError:  # pragma: no cover - zmq is an optional extra
    SerializingSocket = None
    SerializingContext = None


# ----------------------------------------------------------------------
# r_RF estimation: map the RF Gauss filter width ``a`` to the Gaussian
# noise-correlation parameter r_RF.  Same statistical idea as the
# reference's estimator (reference: src/utils.py:175-395): draw many
# realizations of Gaussian-correlated noise, look at the upper envelope
# of their amplitude-spectrum cloud, and fit the RF Gauss filter curve
# exp(-pi^2 f^2 / a^2) to it — the r_RF whose envelope matches the
# filter width of the observed RF is the consistent noise model.
# ----------------------------------------------------------------------

_ENVELOPE_BINS = 120     # 2-D histogram resolution of the spectrum cloud
_ENVELOPE_MIN_HITS = 4   # bins with fewer samples are outlier specks


def _gauss_correlated_noise(size, corr, sigma, draws, rs=None):
    """``draws`` realizations of zero-mean noise with the gaussian
    correlation law C_ij = sigma^2 corr^((i-j)^2), concatenated into
    one long record (the spectrum estimator wants lots of data, not
    lots of arrays)."""
    rs = rstate if rs is None else rs
    lag2 = np.subtract.outer(np.arange(size), np.arange(size)) ** 2
    cov = sigma ** 2 * np.asarray(corr, float) ** lag2
    return rs.multivariate_normal(np.zeros(size), cov, draws).ravel()


def compute_spectrum(y, Fs):
    """Single-sided amplitude spectrum of ``y`` at sampling rate
    ``Fs``, peak-normalized.  Returns (frequencies, amplitudes)."""
    y = np.asarray(y, float)
    n = y.size
    amp = np.abs(np.fft.rfft(y - y.mean()))[:n // 2]
    frq = np.fft.rfftfreq(n, d=1.0 / Fs)[:n // 2]
    return frq, amp / amp.max()


def gauss_fct(a, x):
    """RF Gauss low-pass transfer curve exp(-(2 pi f)^2 / (4 a^2))."""
    return np.exp(-(x * 2 * np.pi) ** 2 / (4 * a ** 2))


def _spectrum_envelope(frq, Y):
    """Upper envelope of the (frq, Y) scatter cloud: per frequency
    bin, the highest amplitude bin that is populated by more than
    ``_ENVELOPE_MIN_HITS`` samples (single specks are noise).
    Returns (bin centers, envelope amplitudes [NaN where empty])."""
    hist, xe, ye = np.histogram2d(frq, Y, bins=_ENVELOPE_BINS)
    occupied = hist > (_ENVELOPE_MIN_HITS - 1)
    # highest occupied y-bin per x-column, vectorized: argmax on the
    # reversed column finds the first True from the top
    top_rev = np.argmax(occupied[:, ::-1], axis=1)
    any_hit = occupied.any(axis=1)
    ycenters = 0.5 * (ye[:-1] + ye[1:])
    env = np.where(any_hit,
                   ycenters[_ENVELOPE_BINS - 1 - top_rev], np.nan)
    return 0.5 * (xe[:-1] + xe[1:]), env


def _fit_gauss_width(frq, env):
    """Filter width ``a`` fitted to an envelope.  The model is
    log-linear (log env = -pi^2 f^2 / a^2), so a closed-form weighted
    regression seeds a scipy refinement in amplitude space (which
    weights the passband like the reference's nonlinear fit)."""
    from scipy.optimize import least_squares

    good = np.isfinite(env) & (env > 0)
    x2 = frq[good] ** 2
    ln = np.log(env[good])
    # amplitude-weighted slope through the origin in (f^2, log env)
    w = env[good] ** 2
    slope = np.sum(w * x2 * ln) / max(np.sum(w * x2 * x2), 1e-30)
    a0 = np.pi / np.sqrt(max(-slope, 1e-12))
    fit = least_squares(lambda a: gauss_fct(a, frq[good]) - env[good],
                        a0)
    return float(fit.x[0])


def rrf_estimate(pars=dict()):
    """For each candidate correlation in ``pars['rrfs']``, the RF
    Gauss filter width ``a`` whose transfer curve envelopes the
    correlated-noise spectrum.  Returns (sorted rrfs, fitted a's)."""
    rfx = np.asarray(pars.get('rfx', np.linspace(-5, 35, 201)))
    dt = pars.get('dt', np.median(np.diff(rfx)))
    rrfs = np.sort(np.asarray(pars.get('rrfs', [0.75, 0.85, 0.95])))
    draws = pars.get('draws', 50000)
    sigma = 0.0125

    a_est = []
    for rrf in rrfs:
        noise = _gauss_correlated_noise(rfx.size, rrf, sigma, draws)
        frq, Y = compute_spectrum(noise, 1.0 / dt)
        efrq, env = _spectrum_envelope(frq, Y)
        a_est.append(_fit_gauss_width(efrq, env / np.nanmax(env)))
    return rrfs, a_est


def plot_rrf_estimate(pars=dict()):
    """Figure version of :func:`rrf_estimate`: the observed RF (and
    its spectrum) on top, each candidate r_RF's noise-spectrum cloud
    with its fitted Gauss envelope below, plus the nominal filter
    curve for the deconvolution width ``pars['a']``."""
    import matplotlib.pyplot as plt

    rfx = np.asarray(pars.get('rfx', np.linspace(-5, 35, 201)))
    rfy = pars.get('rfy', None)
    rfa = pars.get('rfa', None)
    dt = pars.get('dt', np.median(np.diff(rfx)))
    rrfs = np.sort(np.asarray(pars.get('rrfs', [0.75, 0.85, 0.95])))
    a_nominal = pars.get('a', 2.)
    draws = pars.get('draws', 50000)
    sigma = 0.0125

    fig = plt.figure()
    efrq = None
    if rfy is not None:
        ax_rf = fig.add_subplot(2, 1, 1)
        label = 'RF, a=%.1f' % rfa if rfa is not None else 'RF'
        ax_rf.plot(rfx, rfy, 'k', lw=1, label=label)
        ax_rf.set_xlabel('Time in s')
        ax_rf.set_ylabel('Amplitude')
        ax_rf.set_xlim(rfx.min(), rfx.max())
        ax_rf.legend(loc=1)
        frq, Y = compute_spectrum(rfy, 1.0 / dt)
        ax_p = fig.add_subplot(2, 1, 2)
        ax_p.plot(frq, Y, 'k', lw=1, label='RF-spec', zorder=200)
    else:
        ax_p = fig.add_subplot(1, 1, 1)

    for rrf in rrfs:
        noise = _gauss_correlated_noise(rfx.size, rrf, sigma, draws)
        frq, Y = compute_spectrum(noise, 1.0 / dt)
        efrq, env = _spectrum_envelope(frq, Y)
        env_max = np.nanmax(env)
        a_fit = _fit_gauss_width(efrq, env / env_max)
        line, = ax_p.plot(efrq, gauss_fct(a_fit, efrq), lw=1.2,
                          zorder=100,
                          label='a=%.1f; $r_{RF}$=%.2f' % (a_fit, rrf))
        ax_p.plot(frq, Y / env_max, lw=0.3, alpha=0.5,
                  color=line.get_color())

    ax_p.set_xlabel('Frequency in Hz')
    ax_p.set_ylabel('Spectral Power')
    ax_p.set_ylim(ymin=0)
    if efrq is not None:
        ax_p.plot(efrq, gauss_fct(a_nominal, efrq),
                  label='a=%.1f' % a_nominal, color='k', ls='--',
                  zorder=200)
    handles, labels = ax_p.get_legend_handles_labels()
    if labels:
        labels, handles = zip(*sorted(zip(labels, handles),
                                      key=lambda t: t[0]))
        ax_p.legend(handles[::-1], labels[::-1], loc=2,
                    bbox_to_anchor=(1, 1.1))
    fig.subplots_adjust(hspace=0.4)
    return fig
