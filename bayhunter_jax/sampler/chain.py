"""Transdimensional Metropolis-Hastings chain as a lax.scan kernel.

The reference's ``SingleChain`` (reference: src/SingleChain.py) is an
object-oriented sequential loop; here the chain is a pure function
``iterate(state) -> state`` scanned over iterations and vmapped over a
chain batch axis.  Faithful ports:

  * six move types — vs, z-position, layer birth, layer death, noise,
    vp/vs — with dimension moves locked out for the first 1% of
    iterations (src/SingleChain.py:511-517),
  * proposal validity (prior bounds, thickmin, LVZ/HVZ;
    src/SingleChain.py:330-392) — invalid proposals skip the counters
    exactly as the reference does (src/SingleChain.py:540-553),
  * Bodin et al. (2012) birth/death acceptance terms
    (src/SingleChain.py:452-487),
  * per-1000-iteration proposal-width adaptation into [40,45]%
    acceptance with the all-proposed gate and the 0.001 floor
    (src/SingleChain.py:425-450, 584-587),
  * posterior = periodic state snapshots; the reference's
    repeat-by-wait-time weighting over accepted models
    (src/SingleChain.py:646-663) is exactly the per-iteration state
    sequence, so uniform thinning of that sequence is the same
    estimator with stride = iterations/maxmodels.

Transdimensional moves keep static shapes: birth writes into slot ``n``
and resorts; death gathers left over the removed slot.  A proposal with
``n`` outside the layer prior is rejected by the validity mask, so no
clamping logic leaks into the statistics.
"""

import os
import typing
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax, random

from bayhunter_jax.ops.voronoi import (model_is_valid, sort_by_depth,
                                       to_reference_vector)

# move ids
MOVE_VS, MOVE_Z, MOVE_BIRTH, MOVE_DEATH, MOVE_NOISE, MOVE_VPVS = range(6)
# PAR_MAP: move -> propdist/counter index (src/SingleChain.py:21-22)
PARIDX = np.array([0, 1, 2, 2, 3, 4])


class ChainState(typing.NamedTuple):
    key: jax.Array          # PRNG key
    vs: jax.Array           # (NL,) nuclei velocities
    z: jax.Array            # (NL,) nuclei depths (sorted over [:n])
    n: jax.Array            # () int32 — nuclei count incl. halfspace
    vpvs: jax.Array         # ()
    noise: jax.Array        # (2T,) [corr, sigma] per target
    logL: jax.Array         # ()
    misfits: jax.Array      # (T+1,)
    propdist: jax.Array     # (5,)
    accepted: jax.Array     # (5,) int32
    proposed: jax.Array     # (5,) int32
    iiter: jax.Array        # () int32 — negative during burn-in
    cache: typing.Any = ()  # per-target (y_synth, swd roots) forward
    #                         cache of the CURRENT model (evaluator.py)
    cell: jax.Array = 0     # () int32 — dataset row for tomography-
    #                         scale batched observations (0 otherwise)
    fwdfail: jax.Array = 0  # (5,) int32 — proposals rejected because
    #                         the FORWARD solve failed (a dispersion
    #                         period without a root in range; slot
    #                         layout as accepted/proposed).  A
    #                         misconfigured propdist inflating these
    #                         rejections surfaces in the optimizer's
    #                         progress diagnostics instead of silently
    #                         biasing acceptance
    beta: jax.Array = 1.0   # () inverse temperature of this chain's
    #                         tempered target pi_beta ~ L^beta * prior
    #                         (parallel tempering, sampler/tempering
    #                         .py); 1.0 = the untempered posterior.
    #                         beta scales ONLY the likelihood ratio in
    #                         the acceptance rule — proposal-ratio
    #                         terms (Bodin birth/death) are untempered
    swap_accepted: jax.Array = 0  # () int32 — replica exchanges this
    #                         chain accepted as the COLDER pair member
    swap_proposed: jax.Array = 0  # () int32 — exchanges proposed with
    #                         this chain as the colder member; the
    #                         per-rung ratio is the ladder diagnostic
    #                         (tune tmax/ntemps for ~20-40%)


class Sampler(typing.NamedTuple):
    """Bundle returned by :func:`build_sampler`.

    Unpacks as ``init_fn, iterate_fn, run_fn, snapshot_fn`` for
    backward compatibility; ``init_states_host`` is the preferred
    batch initializer (host-side rejection sampling + one device
    evaluation).

    ``step_fn(states, move_id)`` advances the whole batch ONE
    iteration and is the production hot path: iterations are
    dispatched from the host with the per-iteration move id as an
    argument, so that each move id compiles to its own specialized
    program instead of a data-dependent lax.switch inside a scan
    (whose branches a batched lowering may evaluate all of).
    ``moves_for(start, count)``
    returns the deterministic host-side move schedule.
    """
    init_fn: typing.Callable
    iterate_fn: typing.Callable
    run_fn: typing.Callable
    snapshot_fn: typing.Callable
    init_states_host: typing.Callable = None
    step_fn: typing.Callable = None
    moves_for: typing.Callable = None
    # fused move cycles (see build_sampler): ONE device program per
    # full sweep over the move set, input state DONATED; the two
    # dimension slots of ``cycle_fn(states, d1, d2)`` take per-cycle
    # birth/death draws from ``dim_slots_for(it)``.
    # cycle_early_fn excludes dimension moves (first 1% of iterations,
    # src/SingleChain.py:511-517); early_cutoff is the global
    # iteration (counted like state.iiter) where the late set starts.
    cycle_fn: typing.Callable = None
    cycle_early_fn: typing.Callable = None
    cycle_len: int = 0
    cycle_early_len: int = 0
    dim_slots_for: typing.Callable = None
    early_cutoff: float = 0.0
    # per-chain dimension-slot mixture: ``cycle_mixed_fn(states)`` is
    # the single-program sweep used when ``dim_mixture == 'per_chain'``
    # (the default); the four-variant ``cycle_fn`` remains for the
    # 'host' mode and for step-sequence equivalence tests.
    cycle_mixed_fn: typing.Callable = None
    dim_mixture: str = 'per_chain'
    # parallel tempering (attached by sampler/tempering.attach):
    # ``swap_fn(states, parity)`` proposes replica exchanges between
    # adjacent temperature rungs of deterministic even/odd parity;
    # dispatch_cycles calls it every ``swap_every`` cycles with
    # alternating parity (the non-reversible DEO schedule).
    swap_fn: typing.Callable = None
    swap_every: int = 0
    # on-device cycle scan (small-batch operating point): ``
    # cycle_scan_fn(states, k)`` runs k whole mixed cycles in ONE
    # program via lax.scan — every move id inside the cycle body is
    # STATIC, so the scan needs no lax.switch over move ids.
    # Amortizes the per-program dispatch cost where it dominates (the
    # reference's own 21-chain configuration; anything under ~1k
    # chains).
    cycle_scan_fn: typing.Callable = None
    cycle_early_scan_fn: typing.Callable = None

    def __iter__(self):  # 4-tuple unpacking compatibility
        return iter((self.init_fn, self.iterate_fn, self.run_fn,
                     self.snapshot_fn))


class SamplerConfig(typing.NamedTuple):
    """Static (host) configuration; see defaults/defaults.ini and
    reference src/SingleChain.py:33-59."""
    nl: int
    ntargets: int
    vs_prior: tuple
    z_prior: tuple
    layers_prior: tuple
    vpvs_prior: object          # float (fixed) or (lo, hi)
    mohoest: object             # None or (mean, std)
    mantle: object              # None or (vs, vpvs)
    thickmin: float
    lvz: object
    hvz: object
    noise_priors: tuple         # 2T entries: float or (lo, hi)
    propdist: tuple             # 5 initial proposal widths
    acceptance: tuple           # (lo, hi) percent
    iter_burnin: int
    iter_main: int
    dtype: object = jnp.float32
    # dimension-slot identity in the fused cycles: 'host' draws one
    # birth/death coin per cycle on the host (four compiled variants),
    # 'per_chain' draws an independent coin per chain inside ONE
    # compiled program (both proposals are computed — cheap (NL,)
    # arithmetic — and the single forward solve covers the selected
    # one).  Per-chain is the production default: one cycle program
    # instead of four, and each chain's slot is the fair mixture
    # kernel by construction rather than ensemble-wide.
    dim_mixture: str = 'per_chain'

    @property
    def noiseinds(self):
        return tuple(i for i, p in enumerate(self.noise_priors)
                     if not isinstance(p, (int, float)))

    @property
    def vpvs_inverted(self):
        return not isinstance(self.vpvs_prior, (int, float))


def make_config(priors, initparams, noiserefs, nl=None,
                dtype=jnp.float32):
    """Build a SamplerConfig from reference-style priors/initparams
    dicts and the list of target noiserefs ('swd'/'rf' per target)."""
    layers = tuple(int(v) for v in priors['layers'])
    if nl is None:
        nl = layers[1] + 1  # maxlayers (src/mcmcOptimizer.py:64)
    noise_priors = []
    for nref in noiserefs:
        for pname in ('noise_corr', 'noise_sigma'):
            prior = priors[nref + pname]
            if isinstance(prior, (list, tuple)):
                noise_priors.append((float(prior[0]), float(prior[1])))
            else:
                noise_priors.append(float(prior))
    vpvs = priors['vpvs']
    vpvs = float(vpvs) if isinstance(vpvs, (int, float)) \
        else (float(vpvs[0]), float(vpvs[1]))
    mohoest = priors.get('mohoest', None)
    if mohoest is not None:
        mohoest = (float(mohoest[0]), float(mohoest[1]))
    mantle = priors.get('mantle', None)
    if mantle is not None:
        mantle = (float(mantle[0]), float(mantle[1]))
    lvz = priors.get('lvz', None) if 'lvz' in priors else None
    hvz = priors.get('hvz', None) if 'hvz' in priors else None
    # lvz/hvz live in initparams in the reference config
    lvz = initparams.get('lvz', lvz)
    hvz = initparams.get('hvz', hvz)
    return SamplerConfig(
        nl=int(nl),
        ntargets=len(noiserefs),
        vs_prior=tuple(float(v) for v in priors['vs']),
        z_prior=tuple(float(v) for v in priors['z']),
        layers_prior=layers,
        vpvs_prior=vpvs,
        mohoest=mohoest,
        mantle=mantle,
        thickmin=float(initparams['thickmin']),
        lvz=None if lvz is None else float(lvz),
        hvz=None if hvz is None else float(hvz),
        noise_priors=tuple(noise_priors),
        propdist=tuple(float(v) for v in initparams['propdist']),
        acceptance=tuple(float(v) for v in initparams['acceptance']),
        iter_burnin=int(initparams['iter_burnin']),
        iter_main=int(initparams['iter_main']),
        dtype=dtype,
        dim_mixture=str(initparams.get('dim_mixture', 'per_chain')))


def build_sampler(eval_fn, cfg, mesh=None):
    """Return (init_fn, iterate_fn, run_fn, snapshot_fn).

    ``eval_fn(vs, z, n, vpvs, noise) -> (logL, misfits, valid)`` is the
    batched joint-target evaluator (sampler/evaluator.py).

    ``mesh``: a multi-device 1-D chain mesh to shard_map the dispatch
    programs over.  Chains are embarrassingly parallel, but the warm
    root searches are batched while loops whose exit test reduces over
    the whole batch: left to GSPMD, every trip would need a
    cross-device reduction.  shard_map makes each device run the whole
    move program on its own chain shard with zero collectives (each
    shard's loops stop at its own slowest lane); the tempering swap_fn
    stays GSPMD (its cross-chain roll lowers to a collective-permute).
    """
    from jax import shard_map

    if mesh is not None and mesh.size > 1:
        _spec = jax.sharding.PartitionSpec(mesh.axis_names[0])

        def _sharded(f):
            return shard_map(f, mesh=mesh, in_specs=(_spec,),
                             out_specs=_spec, check_vma=False)
    else:
        def _sharded(f):
            return f

    nl = cfg.nl
    dtype = cfg.dtype
    vsmin, vsmax = cfg.vs_prior
    zmin, zmax = cfg.z_prior
    dv = vsmax - vsmin
    acc_lo, acc_hi = cfg.acceptance
    iterations = cfg.iter_burnin + cfg.iter_main
    early_cutoff = -cfg.iter_burnin + iterations * 0.01

    priors_dict = {'layers': cfg.layers_prior, 'vs': cfg.vs_prior,
                   'z': cfg.z_prior}

    noiseinds = np.asarray(cfg.noiseinds, np.int32)
    n_noise = len(cfg.noise_priors)
    noise_lo = np.full(n_noise, -np.inf)
    noise_hi = np.full(n_noise, np.inf)
    for i, p in enumerate(cfg.noise_priors):
        if not isinstance(p, (int, float)):
            noise_lo[i], noise_hi[i] = p
    noise_lo_j = jnp.asarray(noise_lo, dtype)
    noise_hi_j = jnp.asarray(noise_hi, dtype)
    noiseinds_j = jnp.asarray(noiseinds) if noiseinds.size else None

    # move sets (src/SingleChain.py:596-599 & 511-517)
    late_moves = [MOVE_VS, MOVE_Z, MOVE_BIRTH, MOVE_DEATH]
    early_moves = [MOVE_VS, MOVE_Z]
    if noiseinds.size:
        late_moves.append(MOVE_NOISE)
        early_moves.append(MOVE_NOISE)
    if cfg.vpvs_inverted:
        late_moves.append(MOVE_VPVS)
        early_moves.append(MOVE_VPVS)
    late_arr = jnp.asarray(np.array(late_moves, np.int32))
    early_arr = jnp.asarray(np.array(early_moves, np.int32))
    paridx_arr = jnp.asarray(PARIDX)
    # propdist slots that can actually receive proposals given the
    # configured move set (fixed vpvs/noise leave their slots at zero
    # forever; the adaptation gate must ignore those)
    active_slots = np.zeros(5, bool)
    for mv in late_moves:
        active_slots[PARIDX[mv]] = True
    active_slots_j = jnp.asarray(active_slots)

    idx_nl = jnp.arange(nl)
    zero = jnp.zeros((), dtype)

    # ------------------------------------------------------------------
    # move branches — all return (vs, z, n, noise, vpvs, dvs2)
    # ------------------------------------------------------------------

    # NOTE on indexing style: every per-chain dynamic index
    # (``x.at[ind].add``, ``x[ind]``, ``x[perm]``) lowers under vmap
    # to a batched gather/scatter, while the equivalent one-hot select
    # / static-shift formulations fuse into the surrounding
    # elementwise ops.  All move branches therefore use masks, never
    # dynamic indices.

    def _pick1(x, ind):
        """x[ind] as a one-hot reduction (exactly one index matches)."""
        return jnp.sum(jnp.where(jnp.arange(x.shape[-1]) == ind, x,
                                 jnp.zeros((), x.dtype)))

    def move_vs(state, k1, k2):
        """Gaussian Vs perturbation of one nucleus
        (src/SingleChain.py:287-292)."""
        ind = random.randint(k1, (), 0, state.n)
        delta = random.normal(k2, dtype=dtype) * state.propdist[0]
        vs = state.vs + jnp.where(idx_nl == ind, delta, zero)
        return (vs, state.z, state.n,
                state.noise, state.vpvs, zero)

    def move_z(state, k1, k2):
        """Gaussian nucleus-depth move (src/SingleChain.py:294-299)."""
        ind = random.randint(k1, (), 0, state.n)
        delta = random.normal(k2, dtype=dtype) * state.propdist[1]
        z = state.z + jnp.where(idx_nl == ind, delta, zero)
        return (state.vs, z, state.n,
                state.noise, state.vpvs, zero)

    def move_birth(state, k1, k2):
        """Layer birth: new nucleus at uniform depth, Vs from nearest
        nucleus + Gaussian (src/SingleChain.py:246-267)."""
        z_birth = random.uniform(k1, (), dtype, zmin, zmax)
        dist = jnp.where(idx_nl < state.n,
                         jnp.abs(state.z - z_birth), jnp.inf)
        vs_before = _pick1(state.vs, jnp.argmin(dist))
        vs_birth = vs_before \
            + random.normal(k2, dtype=dtype) * state.propdist[2]
        slot = jnp.minimum(state.n, nl - 1)
        at_slot = idx_nl == slot
        vs = jnp.where(at_slot, vs_birth, state.vs)
        z = jnp.where(at_slot, z_birth, state.z)
        dvs2 = jnp.square(vs_birth - vs_before)
        return vs, z, state.n + 1, state.noise, state.vpvs, dvs2

    def move_death(state, k1, k2):
        """Layer death: remove a random nucleus; dvs2 from the nearest
        surviving nucleus (src/SingleChain.py:269-285)."""
        ind = random.randint(k1, (), 0, state.n)
        z_before = _pick1(state.z, ind)
        vs_before = _pick1(state.vs, ind)
        # delete-at-ind == keep below ind, shift-left at/above it
        # (the last slot repeats itself, matching clip(idx+1, nl-1))
        vs_shift = jnp.concatenate([state.vs[1:], state.vs[-1:]])
        z_shift = jnp.concatenate([state.z[1:], state.z[-1:]])
        above = idx_nl >= ind
        vs = jnp.where(above, vs_shift, state.vs)
        z = jnp.where(above, z_shift, state.z)
        n_new = state.n - 1
        dist = jnp.where(idx_nl < n_new, jnp.abs(z - z_before), jnp.inf)
        vs_after = _pick1(vs, jnp.argmin(dist))
        dvs2 = jnp.square(vs_after - vs_before)
        return vs, z, n_new, state.noise, state.vpvs, dvs2

    def move_noise(state, k1, k2):
        """Perturb one non-fixed noise hyperparameter
        (src/SingleChain.py:394-400)."""
        pick = random.randint(k1, (), 0, len(noiseinds))
        ind = _pick1(noiseinds_j, pick)
        delta = random.normal(k2, dtype=dtype) * state.propdist[3]
        noise = state.noise + jnp.where(
            jnp.arange(n_noise) == ind, delta, zero)
        return (state.vs, state.z, state.n,
                noise, state.vpvs, zero)

    def move_vpvs(state, k1, k2):
        """Perturb vp/vs (src/SingleChain.py:409-413)."""
        delta = random.normal(k2, dtype=dtype) * state.propdist[4]
        return (state.vs, state.z, state.n, state.noise,
                state.vpvs + delta, zero)

    branches = [move_vs, move_z, move_birth, move_death]
    branches.append(move_noise if noiseinds.size else move_vs)
    branches.append(move_vpvs)

    def _valid_noise(noise):
        if not noiseinds.size:
            return jnp.asarray(True)
        ok = (noise >= noise_lo_j) & (noise <= noise_hi_j)
        return jnp.all(ok)

    def _valid_vpvs(vpvs):
        if not cfg.vpvs_inverted:
            return jnp.asarray(True)
        lo, hi = cfg.vpvs_prior
        return (vpvs >= lo) & (vpvs <= hi)

    # ------------------------------------------------------------------
    # one Metropolis-Hastings iteration (src/SingleChain.py:511-589)
    #
    # ``move_id`` is a SCALAR shared by the whole chain batch for this
    # iteration (drawn once per iteration in run_fn).  Each chain's
    # marginal transition kernel is the same uniform mixture over move
    # types as the reference's per-chain draw, but a scalar move id
    # keeps lax.switch/lax.cond as real runtime branches under vmap —
    # in particular, noise moves skip the forward solvers entirely and
    # re-score the cached synthetics.
    # ------------------------------------------------------------------

    def _ring_width_for(move_id):
        # warm-search ring half-width per (static) move id, sized to
        # the root-shift distributions under adapted proposal widths:
        # vs moves shift roots by up to tens of DDC grid steps, while
        # z and vp/vs moves shift < 1 step at p99.9 — their solves run
        # a narrower ring.  Birth/death run a MINIMAL ring: their root
        # shifts are bimodal (most lanes move < 1 step, a few percent
        # beyond any practical bound), and the width was tuned on a
        # removed solver that recentred every dimension-move start on
        # its root with Newton steps first.  The plain ring search
        # here has no such recentring, so a dimension step expands its
        # 1-point ring until the slowest lane brackets (up to
        # kblock*nblocks trips, ops/swd.py surfdisp_roots) — the cost
        # to watch in the per-move step times.  The env overrides
        # exist for A/B of the (width x trips) trade-off.
        if isinstance(move_id, int):
            if move_id in (MOVE_BIRTH, MOVE_DEATH):
                return int(os.environ.get('BAYHUNTER_DIM_RING', '1'))
            if move_id == MOVE_Z:
                return int(os.environ.get('BAYHUNTER_NARROW_RING',
                                          '8'))
            if move_id == MOVE_VPVS:
                return int(os.environ.get(
                    'BAYHUNTER_VPVS_RING',
                    os.environ.get('BAYHUNTER_NARROW_RING', '8')))
        return int(os.environ.get('BAYHUNTER_PERT_RING', '16'))

    def propose(state, move_id):
        """Draw a proposal (no forward solve); per chain.

        A STATIC (Python int) ``move_id`` — the production step_fn /
        cycle_fn path — specializes the program: the depth re-sort
        (src/SingleChain.py:315-328) is an exact no-op for moves that
        leave (z, n) unchanged (the state is already depth-sorted and
        the sort keys only on z, stably), so vs/noise/vpvs proposals
        skip it, and noise/vpvs proposals skip the model-validity
        evaluation entirely (their validity is the hyperparameter
        prior alone)."""
        key, k1, k2, k_u = random.split(state.key, 4)

        static_id = move_id if isinstance(move_id, int) else None
        if static_id is not None:
            vs_p, z_p, n_p, noise_p, vpvs_p, dvs2 = branches[static_id](
                state, k1, k2)
        else:
            vs_p, z_p, n_p, noise_p, vpvs_p, dvs2 = lax.switch(
                move_id, branches, state, k1, k2)

        if static_id not in (MOVE_VS, MOVE_NOISE, MOVE_VPVS):
            vs_p, z_p = sort_by_depth(vs_p, z_p, n_p)

        if static_id == MOVE_NOISE:
            valid = _valid_noise(noise_p)
        elif static_id == MOVE_VPVS:
            valid = _valid_vpvs(vpvs_p)
        else:
            vmodel = model_is_valid(vs_p, z_p, n_p, state.vpvs,
                                    priors_dict, cfg.thickmin, cfg.lvz,
                                    cfg.hvz, mantle=cfg.mantle)
            if static_id is not None:
                valid = vmodel
            else:
                valid = jnp.where(move_id < 4, vmodel,
                                  jnp.where(move_id == MOVE_NOISE,
                                            _valid_noise(noise_p),
                                            _valid_vpvs(vpvs_p)))
        u = jnp.log(random.uniform(k_u, dtype=dtype))
        return dict(key=key, vs=vs_p, z=z_p, n=n_p, noise=noise_p,
                    vpvs=vpvs_p, dvs2=dvs2, valid=valid, u=u)

    def propose_dim(state):
        """Per-chain fair birth/death mixture proposal: BOTH directions
        are computed (cheap (NL,) arithmetic) and an independent coin
        per chain selects one — so a single compiled program (and a
        single forward solve) covers the dimension slot, and each
        chain's slot kernel is the 1/2-1/2 Bodin mixture by
        construction (reference proposes birth/death each with
        probability 1/6 per iteration, src/SingleChain.py:503-517)."""
        key, k1, k2, k_coin, k_u = random.split(state.key, 5)
        coin = random.bernoulli(k_coin)        # True -> birth

        vs_b, z_b, n_b, _, _, dvs2_b = move_birth(state, k1, k2)
        vs_d, z_d, n_d, _, _, dvs2_d = move_death(state, k1, k2)

        vs_p = jnp.where(coin, vs_b, vs_d)
        z_p = jnp.where(coin, z_b, z_d)
        n_p = jnp.where(coin, n_b, n_d)
        dvs2 = jnp.where(coin, dvs2_b, dvs2_d)

        vs_p, z_p = sort_by_depth(vs_p, z_p, n_p)
        valid = model_is_valid(vs_p, z_p, n_p, state.vpvs, priors_dict,
                               cfg.thickmin, cfg.lvz, cfg.hvz,
                               mantle=cfg.mantle)
        u = jnp.log(random.uniform(k_u, dtype=dtype))
        sign = jnp.where(coin, jnp.asarray(1.0, dtype),
                         jnp.asarray(-1.0, dtype))
        return dict(key=key, vs=vs_p, z=z_p, n=n_p, noise=state.noise,
                    vpvs=state.vpvs, dvs2=dvs2, valid=valid, u=u,
                    dim_sign=sign)

    def accept_update(state, move_id, prop, logL_p, misfits_p, fvalid,
                      cache_p):
        """Metropolis acceptance + counters + adaptation; per chain.

        For the per-chain birth/death mixture the proposal carries
        ``dim_sign`` (+1 birth, -1 death, per chain) and ``move_id``
        is MOVE_BIRTH for the counter slot; for plain moves the sign
        is implied by the static move id."""
        # acceptance probability (src/SingleChain.py:452-487)
        theta = state.propdist[2]
        log_a_birth = jnp.log(theta * jnp.sqrt(2.0 * jnp.pi) / dv)
        b_term = prop['dvs2'] / (2.0 * jnp.square(theta))
        alpha = state.beta * (logL_p - state.logL)
        if 'dim_sign' in prop:
            alpha = alpha + prop['dim_sign'] * (log_a_birth + b_term)
        else:
            alpha = jnp.where(move_id == MOVE_BIRTH,
                              alpha + log_a_birth + b_term, alpha)
            alpha = jnp.where(move_id == MOVE_DEATH,
                              alpha - log_a_birth - b_term, alpha)

        accept = (prop['u'] < alpha) & prop['valid'] & fvalid

        def sel(new, old):
            return jnp.where(accept, new, old)

        paridx = paridx_arr[move_id]
        onehot = (jnp.arange(5) == paridx)
        proposed = state.proposed + jnp.where(prop['valid'], onehot,
                                              False)
        accepted = state.accepted + jnp.where(accept, onehot, False)
        fwdfail = state.fwdfail + jnp.where(
            prop['valid'] & jnp.logical_not(fvalid), onehot, False)

        # adaptive proposal widths (src/SingleChain.py:425-450,584-587).
        # The gate requires every ACTIVE slot to have received
        # proposals (the reference gates on all five, but slots of
        # fixed parameters never propose — with e.g. a fixed vp/vs its
        # adaptation would never fire); never-proposed slots are left
        # untouched, like the reference's NaN-rate skip.
        do_adapt = (jnp.mod(state.iiter, 1000) == 0) \
            & jnp.all((proposed > 0) | ~active_slots_j)
        rates = accepted / jnp.maximum(proposed, 1) * 100.0
        factor = jnp.where(rates < acc_lo, 0.95,
                           jnp.where(rates > acc_hi, 1.05, 1.0))
        factor = jnp.where(proposed > 0, factor, 1.0)
        new_pd = state.propdist * factor.astype(dtype)
        new_pd = jnp.where((rates < acc_lo) & (proposed > 0),
                           jnp.maximum(new_pd, 0.001), new_pd)
        propdist = jnp.where(do_adapt, new_pd, state.propdist)

        return ChainState(
            key=prop['key'],
            vs=sel(prop['vs'], state.vs),
            z=sel(prop['z'], state.z),
            n=jnp.where(accept, prop['n'], state.n),
            vpvs=sel(prop['vpvs'], state.vpvs),
            noise=sel(prop['noise'], state.noise),
            logL=sel(logL_p, state.logL),
            misfits=sel(misfits_p, state.misfits),
            propdist=propdist,
            accepted=accepted,
            proposed=proposed,
            iiter=state.iiter + 1,
            cache=jax.tree_util.tree_map(sel, cache_p, state.cache),
            cell=state.cell, fwdfail=fwdfail, beta=state.beta,
            swap_accepted=state.swap_accepted,
            swap_proposed=state.swap_proposed)

    def iterate(state, move_id):
        prop = propose(state, move_id)
        ring_width = _ring_width_for(move_id)

        def fwd_full(_):
            return eval_fn.eval_full(prop['vs'], prop['z'], prop['n'],
                                     prop['vpvs'], prop['noise'],
                                     state.cache, state.cell,
                                     ring_width=ring_width)

        def fwd_noise(_):
            logL_n, fvalid_n = eval_fn.eval_noise(prop['noise'],
                                                  state.cache,
                                                  state.cell)
            return logL_n, state.misfits, fvalid_n, state.cache

        logL_p, misfits_p, fvalid, cache_p = lax.cond(
            move_id == MOVE_NOISE, fwd_noise, fwd_full, None)

        new_state = accept_update(state, move_id, prop, logL_p,
                                  misfits_p, fvalid, cache_p)
        return new_state, None

    # ------------------------------------------------------------------
    # initial state (src/SingleChain.py:71-157)
    # ------------------------------------------------------------------

    n_init = cfg.layers_prior[0] + 1  # min layers + halfspace

    def _draw_model(key):
        kv, kz, km, kt = random.split(key, 4)
        vs_d = jnp.sort(random.uniform(kv, (n_init,), dtype, vsmin,
                                       vsmax))
        if cfg.mohoest is not None and n_init > 1:
            mean, std = cfg.mohoest
            moho = mean + std * random.normal(km, dtype=dtype)
            tmp_z = random.uniform(kt, (), dtype, 1.0,
                                   jnp.minimum(5.0, moho))
            z_rest = random.uniform(kz, (n_init,), dtype, zmin, zmax)
            z_d = z_rest.at[0].set(moho - tmp_z).at[1].set(moho + tmp_z)
            if n_init == 2:
                z_d = jnp.stack([moho - tmp_z, moho + tmp_z])
        else:
            z_d = random.uniform(kz, (n_init,), dtype, zmin, zmax)
        z_d = jnp.sort(z_d)
        vs_full = jnp.full((nl,), vs_d[-1], dtype).at[:n_init].set(vs_d)
        z_full = jnp.full((nl,), 2.0 * zmax, dtype).at[:n_init].set(z_d)
        return vs_full, z_full

    def init_fn(key):
        k_vpvs, k_model, k_noise, k_state = random.split(key, 4)

        if cfg.vpvs_inverted:
            lo, hi = cfg.vpvs_prior
            vpvs = random.uniform(k_vpvs, (), dtype, lo, hi)
        else:
            vpvs = jnp.asarray(cfg.vpvs_prior, dtype)

        # redraw until valid (src/SingleChain.py:122-123), bounded
        def cond(carry):
            _, _, _, ok, tries = carry
            return (~ok) & (tries < 64)

        def body(carry):
            key_c, _, _, _, tries = carry
            key_c, kd = random.split(key_c)
            vs_c, z_c = _draw_model(kd)
            ok = model_is_valid(vs_c, z_c, n_init, vpvs, priors_dict,
                                cfg.thickmin, cfg.lvz, cfg.hvz,
                                mantle=cfg.mantle)
            return key_c, vs_c, z_c, ok, tries + 1

        vs0, z0 = _draw_model(k_model)
        ok0 = model_is_valid(vs0, z0, n_init, vpvs, priors_dict,
                             cfg.thickmin, cfg.lvz, cfg.hvz,
                             mantle=cfg.mantle)
        _, vs0, z0, _, _ = lax.while_loop(
            cond, body, (k_model, vs0, z0, ok0, jnp.asarray(0)))

        # noise init (src/SingleChain.py:125-150)
        knoise = random.split(k_noise, max(n_noise, 1))
        noise_vals = []
        for i, p in enumerate(cfg.noise_priors):
            if isinstance(p, (int, float)):
                noise_vals.append(jnp.asarray(p, dtype))
            else:
                noise_vals.append(random.uniform(knoise[i], (), dtype,
                                                 p[0], p[1]))
        noise0 = jnp.stack(noise_vals)

        logL0, misfits0, _, cache0 = eval_fn.eval_cold(
            vs0, z0, jnp.asarray(n_init), vpvs, noise0)
        return ChainState(
            key=k_state, vs=vs0, z=z0,
            n=jnp.asarray(n_init, jnp.int32),
            vpvs=vpvs, noise=noise0, logL=logL0, misfits=misfits0,
            propdist=jnp.asarray(cfg.propdist, dtype),
            accepted=jnp.zeros(5, jnp.int32),
            proposed=jnp.zeros(5, jnp.int32),
            iiter=jnp.asarray(-cfg.iter_burnin, jnp.int32),
            cache=cache0, cell=jnp.zeros((), jnp.int32),
            fwdfail=jnp.zeros(5, jnp.int32),
            beta=jnp.ones((), dtype),
            swap_accepted=jnp.zeros((), jnp.int32),
            swap_proposed=jnp.zeros((), jnp.int32))

    # ------------------------------------------------------------------
    # host-side batch init — numpy rejection sampling like the
    # reference (src/SingleChain.py:94-157), then ONE batched device
    # evaluation.  Avoids compiling a redraw while_loop around the
    # full forward solvers.
    # ------------------------------------------------------------------

    def _valid_host(vs_d, z_d):
        """Vectorized host validity of (m, n_init) initial draws:
        thickness & velocity-zone checks (priors hold by construction).
        """
        z_next = np.concatenate([z_d[:, 1:], z_d[:, -1:]], axis=1)
        z_disc = 0.5 * (z_d + z_next)
        h = np.diff(np.concatenate(
            [np.zeros((z_d.shape[0], 1)), z_disc], axis=1), axis=1)
        ok = np.all(h[:, :n_init - 1] >= cfg.thickmin, axis=1)
        dvs = vs_d[:, 1:]
        vs0 = vs_d[:, :-1]
        if cfg.lvz is not None:
            ok &= np.all(dvs > vs0 * (1.0 - cfg.lvz), axis=1)
        if cfg.hvz is not None:
            ok &= np.all(dvs < vs0 * (1.0 + cfg.hvz), axis=1)
        return ok

    def init_states_host(seed, nchains, eval_batch=None, cells=None,
                         betas=None):
        """Draw ``nchains`` valid initial states with numpy; evaluate
        logL in one batched device call.  ``cells`` optionally assigns
        each chain a dataset row for tomography-scale batched
        observations (see evaluator).  ``betas`` optionally assigns
        each chain an inverse temperature (parallel tempering,
        sampler/tempering.py); default 1.0 everywhere."""
        rs = np.random.RandomState(seed)
        vs_h = np.empty((nchains, n_init))
        z_h = np.empty((nchains, n_init))
        pending = np.arange(nchains)
        for _ in range(1000):
            if pending.size == 0:
                break
            m = pending.size
            vs_d = np.sort(rs.uniform(vsmin, vsmax, (m, n_init)),
                           axis=1)
            if cfg.mohoest is not None and n_init > 1:
                mean, std = cfg.mohoest
                moho = rs.normal(mean, std, (m, 1))
                tmp_z = rs.uniform(1.0, np.minimum(5.0, moho), (m, 1))
                z_d = rs.uniform(zmin, zmax, (m, n_init))
                z_d[:, :1] = moho - tmp_z
                z_d[:, 1:2] = moho + tmp_z
                z_d = np.sort(z_d, axis=1)
            else:
                z_d = np.sort(rs.uniform(zmin, zmax, (m, n_init)),
                              axis=1)
            ok = _valid_host(vs_d, z_d)
            took = pending[ok]
            vs_h[took] = vs_d[ok]
            z_h[took] = z_d[ok]
            pending = pending[~ok]
        if pending.size:
            raise RuntimeError('could not draw valid initial models '
                               'under the given priors')

        if cfg.vpvs_inverted:
            lo, hi = cfg.vpvs_prior
            vpvs_h = rs.uniform(lo, hi, nchains)
        else:
            vpvs_h = np.full(nchains, float(cfg.vpvs_prior))

        noise_h = np.empty((nchains, max(n_noise, 1)))
        for i, p in enumerate(cfg.noise_priors):
            if isinstance(p, (int, float)):
                noise_h[:, i] = p
            else:
                noise_h[:, i] = rs.uniform(p[0], p[1], nchains)

        vs_full = np.concatenate(
            [vs_h, np.repeat(vs_h[:, -1:], nl - n_init, axis=1)],
            axis=1)
        z_full = np.concatenate(
            [z_h, np.full((nchains, nl - n_init), 2.0 * zmax)], axis=1)

        vs_j = jnp.asarray(vs_full, dtype)
        z_j = jnp.asarray(z_full, dtype)
        n_j = jnp.full((nchains,), n_init, jnp.int32)
        vpvs_j = jnp.asarray(vpvs_h, dtype)
        noise_j = jnp.asarray(noise_h, dtype)
        if cells is None:
            cells_j = jnp.zeros((nchains,), jnp.int32)
        else:
            cells_j = jnp.asarray(np.asarray(cells), jnp.int32)
        if eval_batch is None:
            eval_batch = jax.jit(jax.vmap(eval_fn.eval_cold))
        # the cold counting search materializes (chains, periods,
        # block-lanes) intermediates whose size grows with the chain
        # count, so huge batches evaluate in chunks.  Hot-path
        # programs are unaffected (they never run the counting
        # search).
        chunk = int(os.environ.get('BAYHUNTER_INIT_CHUNK', '16384'))
        if nchains > chunk and nchains % chunk == 0:
            parts = [eval_batch(vs_j[i:i + chunk], z_j[i:i + chunk],
                                n_j[i:i + chunk], vpvs_j[i:i + chunk],
                                noise_j[i:i + chunk],
                                cells_j[i:i + chunk])
                     for i in range(0, nchains, chunk)]
            logL_j = jnp.concatenate([p[0] for p in parts])
            misfits_j = jnp.concatenate([p[1] for p in parts])
            cache_j = jax.tree_util.tree_map(
                lambda *xs: jnp.concatenate(xs),
                *[p[3] for p in parts])
        else:
            logL_j, misfits_j, _, cache_j = eval_batch(
                vs_j, z_j, n_j, vpvs_j, noise_j, cells_j)
        keys = jax.random.split(
            jax.random.PRNGKey(int(rs.randint(2 ** 31))), nchains)
        return ChainState(
            key=keys, vs=vs_j, z=z_j, n=n_j, vpvs=vpvs_j,
            noise=noise_j, logL=logL_j, misfits=misfits_j,
            propdist=jnp.broadcast_to(jnp.asarray(cfg.propdist, dtype),
                                      (nchains, 5)),
            accepted=jnp.zeros((nchains, 5), jnp.int32),
            proposed=jnp.zeros((nchains, 5), jnp.int32),
            iiter=jnp.full((nchains,), -cfg.iter_burnin, jnp.int32),
            cache=cache_j, cell=cells_j,
            fwdfail=jnp.zeros((nchains, 5), jnp.int32),
            beta=(jnp.ones((nchains,), dtype) if betas is None
                  else jnp.asarray(np.asarray(betas), dtype)),
            swap_accepted=jnp.zeros((nchains,), jnp.int32),
            swap_proposed=jnp.zeros((nchains,), jnp.int32))

    # ------------------------------------------------------------------
    # runners — iterations are the OUTER scan, chains the inner vmap,
    # so the per-iteration move id is a scalar (real branches, see
    # iterate above).
    # ------------------------------------------------------------------

    schedule_key = random.PRNGKey(20190523)  # move-type schedule

    def _move_for(it):
        """Scalar move id for global iteration counter ``it`` (counted
        from -iter_burnin like state.iiter)."""
        k = random.fold_in(schedule_key, it)
        early = it < early_cutoff
        pick_e = random.randint(k, (), 0, len(early_moves))
        pick_l = random.randint(k, (), 0, len(late_moves))
        return jnp.where(early, early_arr[pick_e], late_arr[pick_l])

    iterate_batch = jax.vmap(iterate, in_axes=(0, None))

    def snapshot_fn(state):
        """Posterior sample record in the reference's save layout
        (src/SingleChain.py:665-690)."""
        return dict(
            model=to_reference_vector(state.vs, state.z, state.n),
            logL=state.logL,
            misfits=state.misfits,
            noise=state.noise,
            vpvs=state.vpvs)

    @partial(jax.jit, static_argnames=('n_snap', 'thin'))
    def run_fn(states, n_snap, thin):
        """Advance a BATCHED state pytree ``n_snap*thin`` iterations,
        snapshotting every ``thin``.  Returns ``(states, snapshots)``
        with snapshot arrays shaped (n_snap, nchains, ...).

        Convenience/test path — production dispatches ``step_fn`` from
        the host (see Sampler docstring)."""
        def one(st, _):
            it = st.iiter[0]
            st2, _ = iterate_batch(st, _move_for(it))
            return st2, None

        def chunk(st, _):
            st2, _ = lax.scan(one, st, None, length=thin)
            return st2, jax.vmap(snapshot_fn)(st2)

        return lax.scan(chunk, states, None, length=n_snap)

    def _step_static(states, move_id):
        """One batched iteration with a STATIC (python int) move id —
        the traced body shared by step_fn and the fused cycles."""
        st2, _ = iterate_batch(states, move_id)
        return st2

    def _step_dim(states):
        """One batched dimension-slot iteration with the PER-CHAIN
        birth/death mixture (propose_dim): both directions share the
        single forward solve, so one traced body covers the slot."""
        prop = jax.vmap(propose_dim)(states)
        rw = _ring_width_for(MOVE_BIRTH)
        logL_p, misfits_p, fvalid, cache_p = jax.vmap(
            lambda p, s: eval_fn.eval_full(
                p['vs'], p['z'], p['n'], p['vpvs'], p['noise'],
                s.cache, s.cell, ring_width=rw))(prop, states)
        # move id only routes the counter slot (birth and death share
        # propdist/counter index 2); the acceptance sign is per chain
        return jax.vmap(
            lambda s, p, l, m, f, c:
            accept_update(s, MOVE_BIRTH, p, l, m, f, c)
        )(states, prop, logL_p, misfits_p, fvalid, cache_p)

    @partial(jax.jit, static_argnums=(1,))
    def step_fn(states, move_id):
        """One batched iteration; each move id compiles to its own
        specialized program (a noise step contains no forward solvers
        at all), eliminating runtime conditionals entirely."""
        return _sharded(lambda s: _step_static(s, move_id))(states)

    # ------------------------------------------------------------------
    # fused move cycles — the production dispatch unit.
    #
    # Every program call pays a fixed host dispatch and launch cost,
    # which at small batches is comparable to the compute of a whole
    # sampling step.  A cycle applies one full sweep over the move set inside ONE
    # program (systematic-scan Metropolis-Hastings).  Perturbation
    # kernels (vs/z/noise/vpvs) are individually pi-invariant, so any
    # fixed order is valid; birth and death are NOT individually
    # invariant — each proposes only one direction of the dimension
    # jump, and the Bodin acceptance ratio assumes the reverse move is
    # proposed with equal probability — so the two dimension SLOTS in
    # the cycle get their identity (birth or death) drawn by the HOST
    # per cycle, making each slot the fair birth/death mixture kernel
    # (which is invariant).  Four compiled variants cover the
    # (slot1, slot2) combinations; ``dim_slots_for`` supplies the
    # deterministic per-cycle draw.  The input state is DONATED:
    # callers must rebind `states = cycle_fn(states, d1, d2)` and
    # never touch the old pytree again.
    # ------------------------------------------------------------------

    has_dims = MOVE_BIRTH in late_moves
    # cycle template: dimension slots are placeholders filled per call
    cycle_moves = tuple(m for m in late_moves
                        if m not in (MOVE_BIRTH, MOVE_DEATH))
    n_dim_slots = 2 if has_dims else 0
    cycle_early_moves = tuple(early_moves)

    @partial(jax.jit, static_argnums=(1, 2), donate_argnums=0)
    def cycle_fn(states, d1=MOVE_BIRTH, d2=MOVE_DEATH):
        """One late-phase sweep: vs, z, <d1>, <d2>, then the
        noise/vpvs moves of the configured set.  ``d1``/``d2`` are the
        per-cycle dimension-slot draws (MOVE_BIRTH or MOVE_DEATH)."""
        order = [MOVE_VS, MOVE_Z]
        if has_dims:
            order += [int(d1), int(d2)]
        order += [m for m in cycle_moves if m not in (MOVE_VS, MOVE_Z)]

        def body(states):
            for mid in order:
                states = _step_static(states, int(mid))
            return states
        return _sharded(body)(states)

    def _cycle_mixed_body(states):
        states = _step_static(states, MOVE_VS)
        states = _step_static(states, MOVE_Z)
        if has_dims:
            states = _step_dim(states)
            states = _step_dim(states)
        for mid in cycle_moves:
            if mid not in (MOVE_VS, MOVE_Z):
                states = _step_static(states, int(mid))
        return states

    def _cycle_early_body(states):
        for mid in cycle_early_moves:
            states = _step_static(states, int(mid))
        return states

    @partial(jax.jit, donate_argnums=0)
    def cycle_mixed_fn(states):
        """One late-phase sweep with PER-CHAIN dimension slots: vs, z,
        dim, dim, then the configured noise/vpvs moves — a single
        compiled program covers every slot outcome (vs four host-slot
        variants), and each chain's slot is the fair birth/death
        mixture kernel by construction."""
        return _sharded(_cycle_mixed_body)(states)

    @partial(jax.jit, donate_argnums=0)
    def cycle_early_fn(states):
        return _sharded(_cycle_early_body)(states)

    # on-device cycle scan: k whole sweeps per program.  The cycle
    # body has no host inputs — dimension-slot coins are drawn per
    # chain from state.key (propose_dim) and the adaptation gate rides
    # state.iiter — and every move id in it is STATIC, so a lax.scan
    # over whole cycles needs no lax.switch over move ids (see the
    # Sampler docstring).  This amortizes the per-program dispatch
    # cost, which dominates below ~1k chains (the reference's own
    # configuration is 21 chains, tutorial.rst:294-303).

    @partial(jax.jit, static_argnums=(1,), donate_argnums=0)
    def cycle_scan_fn(states, ncycles):
        def body(st):
            st, _ = lax.scan(
                lambda s, _: (_cycle_mixed_body(s), None),
                st, None, length=ncycles)
            return st
        return _sharded(body)(states)

    @partial(jax.jit, static_argnums=(1,), donate_argnums=0)
    def cycle_early_scan_fn(states, ncycles):
        def body(st):
            st, _ = lax.scan(
                lambda s, _: (_cycle_early_body(s), None),
                st, None, length=ncycles)
            return st
        return _sharded(body)(states)

    def dim_slots_for(it):
        """Deterministic (birth|death, birth|death) draw for the cycle
        starting at global iteration ``it`` — independent of the chain
        state, so each dimension slot is the fair mixture kernel.
        Pure host-side (NO device call: a per-cycle device round-trip
        would force a pipeline sync and serialize dispatch)."""
        rs = np.random.RandomState((20120831 + int(it)) & 0x7fffffff)
        d = rs.randint(0, 2, 2)
        return (MOVE_BIRTH if d[0] == 0 else MOVE_DEATH,
                MOVE_BIRTH if d[1] == 0 else MOVE_DEATH)

    cycle_len = len(cycle_moves) + n_dim_slots

    _moves_jit = jax.jit(jax.vmap(_move_for))

    def moves_for(start_it, count):
        """Host move schedule for global iterations
        [start_it, start_it+count) — identical to run_fn's on-device
        schedule (same fold_in key)."""
        its = jnp.arange(start_it, start_it + count, dtype=jnp.int32)
        return np.asarray(_moves_jit(its))

    return Sampler(init_fn, iterate, run_fn, snapshot_fn,
                   init_states_host, step_fn, moves_for,
                   cycle_fn, cycle_early_fn, cycle_len,
                   len(cycle_early_moves), dim_slots_for,
                   early_cutoff, cycle_mixed_fn,
                   getattr(cfg, 'dim_mixture', 'per_chain'),
                   cycle_scan_fn=cycle_scan_fn,
                   cycle_early_scan_fn=cycle_early_scan_fn)


def precompile_cycles(sampler, states, include_steps=False):
    """AOT-compile every dispatch program CONCURRENTLY: the early
    cycle, all four dimension-slot variants of ``cycle_fn`` and
    (optionally) the six per-step programs.

    XLA compiles release the interpreter lock, so k programs compiled
    in threads overlap.  ``lower().compile()`` routes through the
    same persistent-compile-cache layer as jit dispatch, so the
    subsequent first CALL of each program deserializes from the cache
    instead of recompiling — which needs a persistent cache
    (bayhunter_jax/device.py enable_compile_cache); without one the
    first call compiles again.

    ``states`` is only lowered against (shapes/dtypes/shardings);
    its buffers are not consumed.  Returns the compiled
    executables."""
    import concurrent.futures as cf

    jobs = []
    k_scan = scan_cycles_for(states.n.shape[0])
    if sampler.cycle_early_len:
        jobs.append(lambda: sampler.cycle_early_fn.lower(states))
        if k_scan > 1 and sampler.cycle_early_scan_fn is not None:
            jobs.append(lambda: sampler.cycle_early_scan_fn.lower(
                states, k_scan))
    if sampler.cycle_len:
        if (sampler.dim_mixture == 'per_chain'
                and sampler.cycle_mixed_fn is not None):
            jobs.append(lambda: sampler.cycle_mixed_fn.lower(states))
            if k_scan > 1 and sampler.cycle_scan_fn is not None:
                jobs.append(lambda: sampler.cycle_scan_fn.lower(
                    states, k_scan))
        else:
            for d1, d2 in ((MOVE_BIRTH, MOVE_BIRTH),
                           (MOVE_BIRTH, MOVE_DEATH),
                           (MOVE_DEATH, MOVE_BIRTH),
                           (MOVE_DEATH, MOVE_DEATH)):
                jobs.append(lambda d1=d1, d2=d2:
                            sampler.cycle_fn.lower(states, d1, d2))
    if sampler.swap_fn is not None and sampler.swap_every > 0:
        for parity in (0, 1):
            jobs.append(lambda p=parity:
                        sampler.swap_fn.lower(states, p))
    if include_steps:
        for m in range(6):
            jobs.append(lambda m=m: sampler.step_fn.lower(states, m))
    with cf.ThreadPoolExecutor(max_workers=len(jobs)) as ex:
        futures = [ex.submit(lambda j=j: j().compile()) for j in jobs]
        return [f.result() for f in futures]


def scan_cycles_for(nchains):
    """Cycles per dispatched program (the on-device cycle scan).

    ``BAYHUNTER_SCAN_CYCLES``: unset/'auto' picks by batch size — the
    per-program dispatch cost dominates small batches (the
    reference's own 21-chain configuration), while at >=4k chains a
    cycle's compute dwarfs it and scanning only delays host sync; an
    explicit integer pins k (1 disables)."""
    env = os.environ.get('BAYHUNTER_SCAN_CYCLES', 'auto')
    if env != 'auto':
        return max(1, int(env))
    return int(max(1, min(16, 4096 // max(int(nchains), 1))))


def dispatch_cycles(sampler, states, it_global, count, sync_every=4):
    """Advance a batched state exactly ``count`` iterations from
    global iteration ``it_global`` (counted like ``state.iiter``)
    using the sampler's fused cycles — the shared host hot loop of
    the optimizer, bench and tomography drivers.

    Whole cycles are dispatched (early variant before the sampler's
    ``early_cutoff``, dimension-slot draws from ``dim_slots_for``);
    where the batch is small enough that the per-program dispatch
    cost dominates, k whole cycles go into ONE program via the sampler's
    lax.scan path (``scan_cycles_for``; never across a tempering
    swap boundary or the early/late cutoff).  A remainder finer than
    one cycle falls back to per-step dispatch on the random-scan
    schedule.  The async dispatch queue is bounded by syncing every
    ``sync_every`` cycle calls.  Cycle inputs are DONATED — callers
    must use only the returned states.
    """
    done = 0
    ncalls = 0
    k_scan = scan_cycles_for(states.n.shape[0])
    while done < count:
        early = (it_global + done) < sampler.early_cutoff
        cl = sampler.cycle_early_len if early else sampler.cycle_len
        if cl <= 0 or count - done < cl:
            # per-step fallback also covers a degenerate empty cycle
            # (cl == 0 would otherwise spin this loop forever)
            for m in sampler.moves_for(it_global + done, count - done):
                states = sampler.step_fn(states, int(m))
            done = count
            break
        # how many whole cycles may ride one program: bounded by the
        # remaining request, the early/late cutoff and the next
        # tempering swap sweep.  Each distinct k is its own compiled
        # program, so k collapses to {k_scan, 1}: scan only when a
        # full k_scan block fits, single cycles otherwise.
        k = min(k_scan, (count - done) // cl)
        if early:
            k = min(k, int(max(1, np.ceil(
                (sampler.early_cutoff - (it_global + done)) / cl))))
        if sampler.swap_fn is not None and sampler.swap_every > 0:
            k = min(k, sampler.swap_every
                    - (ncalls % sampler.swap_every))
        if k < k_scan:
            k = 1
        per_chain = (sampler.dim_mixture == 'per_chain'
                     and sampler.cycle_mixed_fn is not None)
        scan_fn = (sampler.cycle_early_scan_fn if early
                   else sampler.cycle_scan_fn)
        if k > 1 and scan_fn is not None and (early or per_chain):
            states = scan_fn(states, int(k))
        elif early:
            k = 1
            states = sampler.cycle_early_fn(states)
        elif per_chain:
            k = 1
            states = sampler.cycle_mixed_fn(states)
        else:
            k = 1
            d1, d2 = sampler.dim_slots_for(it_global + done)
            states = sampler.cycle_fn(states, d1, d2)
        done += cl * k
        ncalls += k
        if (sampler.swap_fn is not None and sampler.swap_every > 0
                and (ncalls % sampler.swap_every) == 0):
            # replica-exchange sweep between move cycles; parity
            # alternates per sweep (deterministic even-odd schedule)
            states = sampler.swap_fn(
                states, (ncalls // sampler.swap_every) % 2)
        if sync_every and (ncalls % sync_every) == 0:
            jax.block_until_ready(states.logL)
    return states


def _resort_body(states, perm, block):
    C = states.n.shape[0]
    if block > 1:
        key = states.n.reshape(-1, block)[:, 0]
        ob = jnp.argsort(key)
        order = (ob[:, None] * block
                 + jnp.arange(block, dtype=ob.dtype)).reshape(-1)
    else:
        order = jnp.argsort(states.n)
    new_states = jax.tree.map(
        lambda x: x[order] if (getattr(x, 'ndim', 0) > 0
                               and x.shape[0] == C) else x, states)
    return new_states, perm[order]


@partial(jax.jit, static_argnums=(2, 3), donate_argnums=(0, 1))
def resort_states(states, perm, block=1, mesh=None):
    """Reorder chain rows by layer count ``n`` (stable sort).

    Made for kernels that skip padded layers per tile of chains,
    where sorted rows make tiles n-homogeneous; the plain vmapped
    path has no tiles (see optimizer.py resort_chains).  Chains are
    exchangeable and their randomness rides ``states.key`` (the host
    move schedule is chain-independent), so resorting is a pure
    relabeling: every chain's trajectory is bit-identical to the
    unsorted run.

    ``block`` > 1 moves whole consecutive row blocks together keyed on
    the block's first row — use ``block=ntemps`` under parallel
    tempering (rung-fastest layout, sampler/tempering.py) so
    temperature groups stay contiguous for the swap sweeps.

    ``mesh``: for a sharded batch, sort WITHIN each device's shard via
    shard_map (chains stay put; a global argsort would gather across
    devices).

    ``perm`` is the running row->original-chain map (init
    ``jnp.arange(C)``, committed to the same sharding as the states);
    callers un-permute host snapshots with it.  Call between dispatch
    segments (one extra small program).
    """
    if mesh is not None and mesh.size > 1:
        from jax import shard_map
        spec = jax.sharding.PartitionSpec(mesh.axis_names[0])
        return shard_map(partial(_resort_body, block=block),
                         mesh=mesh, in_specs=(spec, spec),
                         out_specs=(spec, spec),
                         check_vma=False)(states, perm)
    return _resort_body(states, perm, block)


class SingleChain(object):
    """Reference-compatible single-chain front end
    (reference: src/SingleChain.py:25-690) over the batched sampler.

    The production path runs thousands of chains through
    ``MCMC_Optimizer``; this class exists for API parity and for
    debugging a single chain.  After :meth:`run_chain`, the thinned
    posterior is available as ``p1models/p2models`` (reference-layout
    NaN-padded vectors), ``p1likes/p2likes`` etc.
    """

    def __init__(self, targets, chainidx=0, initparams=None,
                 modelpriors=None, sharedmodels=None, sharedmisfits=None,
                 sharedlikes=None, sharednoise=None, sharedvpvs=None,
                 random_seed=None):
        from bayhunter_jax import config as cfgio
        from bayhunter_jax.sampler.evaluator import build_evaluator

        defaults = cfgio.get_path('defaults.ini')
        self.priors, self.initparams = cfgio.load_params(defaults)
        self.priors.update(modelpriors or {})
        self.initparams.update(initparams or {})
        self.chainidx = chainidx
        self.targets = targets

        nl = int(self.priors['layers'][1]) + 1
        noiserefs = [t.noiseref for t in targets.targets]
        self.cfg = make_config(self.priors, self.initparams, noiserefs,
                               nl=nl)
        self.eval_fn = build_evaluator(targets, self.priors,
                                       self.initparams, nl)
        self.sampler = build_sampler(self.eval_fn, self.cfg)
        self.seed = (random_seed if random_seed is not None
                     else np.random.RandomState().randint(2 ** 31))

    def run_chain(self):
        maxmodels = int(self.initparams.get('maxmodels', 50000))
        states = self.sampler.init_states_host(self.seed, 1)
        for phase, niter in (('p1', self.cfg.iter_burnin),
                             ('p2', self.cfg.iter_main)):
            thin = max(1, int(np.ceil(niter / maxmodels)))
            n_snap = max(1, niter // thin)
            states, snaps = self.sampler.run_fn(states, n_snap, thin)
            setattr(self, phase + 'models',
                    np.asarray(snaps['model'])[:, 0])
            setattr(self, phase + 'likes',
                    np.asarray(snaps['logL'])[:, 0])
            setattr(self, phase + 'misfits',
                    np.asarray(snaps['misfits'])[:, 0])
            setattr(self, phase + 'noise',
                    np.asarray(snaps['noise'])[:, 0])
            setattr(self, phase + 'vpvs',
                    np.asarray(snaps['vpvs'])[:, 0])
        self.final_state = states
        return self
