"""Parallel tempering (replica exchange) over the batched chain axis.

An extension beyond the reference (which runs fully independent
chains; SURVEY.md lists inter-chain sync as "none — optionally expose
as future work").  Transdimensional posteriors of this family are
multimodal in layer count and interface depth; tempering lets hot
replicas cross likelihood valleys and hands good models down to the
cold chains.

Design
------
The temperature ladder lives ON the chain batch axis: chain ``i``
samples the tempered target ``L(m)^beta * prior(m)`` with
``beta = betas[i % ntemps]`` (``ChainState.beta`` scales only the
likelihood ratio in the Metropolis rule, sampler/chain.py
``accept_update``).  Chains are grouped as ``[group, rung]`` with the
rung fastest, so a batch of ``C`` chains is ``C // ntemps``
independent tempered ensembles — the posterior ensemble is the
``beta == 1`` subset (every ``ntemps``-th chain).

A swap sweep proposes exchanges between ADJACENT rungs ``(t, t+1)``
of one parity (even ``t`` or odd ``t``) for every group at once.
Neighbour states are brought in with ``jnp.roll`` along the chain
axis — a static shift that XLA lowers to a local copy on one device
and to a collective-permute between devices when the chain axis is
sharded across a mesh, so the same program scales from one device to
several with no host gathers.  Parity alternates deterministically
between sweeps (the non-reversible DEO schedule of Okabe et al. 2001
/ Syed et al. 2019, which mixes better than random pair choice).

Swapping moves the MODEL payload (vs, z, n, vpvs, noise, logL,
misfits, forward cache) between the paired chains and leaves the
rung-bound quantities (beta, proposal widths, adaptation counters,
PRNG key) attached to their slot, so each rung's proposal widths
keep adapting to its own tempered target.

Exchange acceptance: ``log u < (beta_lo - beta_hi) *
(logL_hi - logL_lo)`` — the standard replica-exchange ratio (prior
and proposal terms cancel; only the tempered likelihoods differ).
Sentinel states (logL = -1e15, failed forward solves) produce
``-inf``-like differences and never swap upward.
"""

import typing
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax import random

from bayhunter_jax.sampler.chain import ChainState

# state fields exchanged by an accepted swap (the model payload and
# everything derived from it); beta/propdist/counters/key/iiter/cell
# stay bound to the chain slot (= the temperature rung)
_SWAP_FIELDS = ('vs', 'z', 'n', 'vpvs', 'noise', 'logL', 'misfits',
                'cache')


def make_ladder(ntemps, tmax):
    """Geometric inverse-temperature ladder ``1 = beta_0 > ... >
    beta_{ntemps-1} = 1/tmax``.

    Geometric spacing equalizes the expected swap rate between
    adjacent rungs when the log-likelihood scale is roughly constant
    across temperatures — the standard default ladder.
    """
    ntemps = int(ntemps)
    if ntemps < 1:
        raise ValueError('ntemps must be >= 1')
    if ntemps == 1:
        return np.ones(1)
    tmax = float(tmax)
    if tmax <= 1.0:
        raise ValueError('tmax must be > 1')
    return tmax ** (-np.arange(ntemps) / (ntemps - 1.0))


def chain_betas(nchains, ntemps, tmax):
    """Per-chain inverse temperatures for the ``[group, rung]`` layout
    (rung fastest): chain ``i`` gets ``ladder[i % ntemps]``.
    ``nchains`` must be a multiple of ``ntemps``."""
    if nchains % ntemps:
        raise ValueError('nchains (%d) must be a multiple of ntemps '
                         '(%d)' % (nchains, ntemps))
    return np.tile(make_ladder(ntemps, tmax), nchains // ntemps)


def build_swap_fn(ntemps, dtype=jnp.float32):
    """Jitted ``swap_fn(states, parity) -> states`` proposing one
    replica-exchange sweep between adjacent rungs of the given parity
    for every temperature group in the batch.

    The input state is DONATED (the sweep rebinds the whole pytree);
    callers must use only the returned states.
    """
    ntemps = int(ntemps)

    @partial(jax.jit, static_argnums=(1,), donate_argnums=0)
    def swap_fn(states, parity):
        C = states.logL.shape[0]
        rung = jnp.arange(C) % ntemps

        # pair (t, t+1) with t of the sweep's parity; the LOWER (t,
        # colder) member owns the pair's uniform draw
        is_lo = ((rung % 2) == parity) & (rung + 1 < ntemps)
        is_hi = (rung >= 1) & (((rung - 1) % 2) == parity)

        def dn(x):  # neighbour below in index order = rung + 1
            return jnp.roll(x, -1, axis=0)

        def up(x):  # neighbour above in index order = rung - 1
            return jnp.roll(x, 1, axis=0)

        keys = jax.vmap(random.split)(states.key)
        new_key, k_u = keys[:, 0], keys[:, 1]
        logu = jnp.log(jax.vmap(
            lambda k: random.uniform(k, (), dtype))(k_u))

        # exchange ratio, evaluated at the lower member
        d = (states.beta - dn(states.beta)) \
            * (dn(states.logL) - states.logL)
        acc_lo = is_lo & (logu < d)
        accept = jnp.where(is_lo, acc_lo, up(acc_lo) & is_hi)

        updates = {}
        for name in _SWAP_FIELDS:
            mine = getattr(states, name)
            updates[name] = jax.tree_util.tree_map(
                lambda x: jnp.where(
                    _bcast(accept, x),
                    jnp.where(_bcast(is_lo, x), dn(x), up(x)), x),
                mine)
        # ladder diagnostics, counted at the colder pair member
        updates['swap_proposed'] = states.swap_proposed \
            + is_lo.astype(jnp.int32)
        updates['swap_accepted'] = states.swap_accepted \
            + acc_lo.astype(jnp.int32)
        return states._replace(key=new_key, **updates)

    return swap_fn


def _bcast(mask, x):
    """Broadcast a (C,) mask against a (C, ...) leaf."""
    return mask.reshape(mask.shape + (1,) * (x.ndim - 1))


def rung_swap_rates(swap_accepted, swap_proposed, ntemps, prev=None):
    """Windowed per-gap swap acceptance rates.

    Gap ``r`` (r = 0..ntemps-2) is the exchange between rungs r and
    r+1, counted at the colder member (slot rung == r).  ``prev``
    optionally holds a prior (accepted, proposed) cumulative snapshot;
    the returned rates cover only the window since then.  Returns
    ``(rates, proposed_per_gap)``.
    """
    acc = np.asarray(swap_accepted).astype(np.int64)
    prop = np.asarray(swap_proposed).astype(np.int64)
    if prev is not None:
        acc = acc - np.asarray(prev[0], np.int64)
        prop = prop - np.asarray(prev[1], np.int64)
    rung = np.arange(acc.shape[0]) % ntemps
    rates = np.zeros(ntemps - 1)
    nprop = np.zeros(ntemps - 1, np.int64)
    for r in range(ntemps - 1):
        m = rung == r
        nprop[r] = prop[m].sum()
        rates[r] = acc[m].sum() / max(nprop[r], 1)
    return rates, nprop


def adapt_ladder(rung_betas, rates, step):
    """One stochastic-approximation update of the temperature ladder
    toward equal adjacent swap rates (Vousden et al. 2016 style,
    with both ends anchored).

    The log gap ``S_r = log(T_r - T_{r-1})`` of each adjacent pair
    grows when its swap rate exceeds the mean and shrinks when below;
    the gaps are then rescaled so T_0 = 1 and T_{ntemps-1} keep their
    values.  Fixed point: all adjacent rates equal.  ``step`` is the
    (decaying) adaptation gain.
    """
    T = 1.0 / np.asarray(rung_betas, float)
    N = T.size
    if N < 3:
        return np.asarray(rung_betas, float)
    S = np.log(np.diff(T))
    S = S + step * (rates - rates.mean())
    gaps = np.exp(S)
    gaps = gaps * (T[-1] - T[0]) / gaps.sum()   # re-anchor the top
    T_new = T[0] + np.concatenate([[0.0], np.cumsum(gaps)])
    return 1.0 / T_new


class TemperingPlan(typing.NamedTuple):
    """Host-side bookkeeping for a tempered run."""
    ntemps: int
    tmax: float
    swap_every: int
    betas: np.ndarray      # per-chain, [group, rung] layout

    def cold_indices(self, nchains_total):
        return np.arange(0, nchains_total, self.ntemps)


def attach(sampler, nchains, ntemps, tmax=1000.0, swap_every=1,
           dtype=jnp.float32):
    """Return ``(sampler', plan)`` with replica-exchange sweeps wired
    into the sampler's dispatch loop.

    ``sampler'`` is the input Sampler with ``swap_fn``/``swap_every``
    populated — ``dispatch_cycles`` then issues one swap sweep every
    ``swap_every`` fused move cycles, parity alternating (DEO).
    Initialize the batch with ``init_states_host(..., betas=
    plan.betas)``; the posterior is the ``plan.cold_indices(...)``
    subset of the chain axis.
    """
    plan = TemperingPlan(int(ntemps), float(tmax), int(swap_every),
                         chain_betas(nchains, ntemps, tmax))
    if ntemps == 1:
        return sampler, plan
    # NOTE: Sampler overrides __iter__ for 4-tuple unpacking compat,
    # which breaks namedtuple._replace (it re-iterates self) — build
    # the replacement by field name instead
    fields = {f: getattr(sampler, f) for f in sampler._fields}
    fields['swap_fn'] = build_swap_fn(ntemps, dtype)
    fields['swap_every'] = int(swap_every)
    return type(sampler)(**fields), plan
