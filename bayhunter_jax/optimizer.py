"""MCMC orchestrator: thousands of chains as one batched device program.

API-compatible with the reference ``MCMC_Optimizer``
(reference: src/mcmcOptimizer.py:31-282), redesigned for one
accelerator program:

  * the reference runs one OS process per chain with shared-memory
    result arrays; here chains are a vmapped batch axis executed in a
    single XLA program, sharded across all visible devices with
    ``jax.sharding`` (chains are independent — the sampling programs
    hold no collectives; scaling is embarrassingly parallel),
  * the sequential per-chain loop becomes host-dispatched batched
    steps (sampler/chain.py step_fn — one specialized program per
    move type); between sync segments the host logs progress,
    optionally publishes BayWatch telemetry over the reference's ZMQ
    wire format, and checkpoints,
  * results are written in the reference's on-disk contract:
    ``c%03d_p{1,2}{models,likes,misfits,noise,vpvs}.npy`` per chain
    plus the ``<station>_config.pkl`` pickle
    (reference: src/SingleChain.py:665-690, src/mcmcOptimizer.py:52-55).
"""

import logging
import os
import os.path as op
import time

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from bayhunter_jax import config as cfgio
from bayhunter_jax import device
from bayhunter_jax.sampler.chain import (build_sampler,
                                         dispatch_cycles, make_config,
                                         precompile_cycles,
                                         resort_states)
from bayhunter_jax.sampler.evaluator import build_evaluator

logger = logging.getLogger(__name__)


class MCMC_Optimizer(object):
    """Joint McMC inversion over many parallel chains."""

    def __init__(self, targets, initparams=dict(), priors=dict(),
                 random_seed=None, dtype=jnp.float32, devices=None):
        self.sock_addr = 'tcp://*:5556'
        self.rstate = np.random.RandomState(random_seed)
        self.seed = random_seed if random_seed is not None \
            else int(self.rstate.randint(2 ** 31))

        defaults = cfgio.get_path('defaults.ini')
        self.priors, self.initparams = cfgio.load_params(defaults)
        self.priors.update(priors)
        self.initparams.update(initparams)

        self.station = self.initparams.get('station')
        self.savepath = op.join(self.initparams['savepath'], 'data')
        os.makedirs(self.savepath, exist_ok=True)

        # config pickle for offline plotting (src/mcmcOptimizer.py:52-55)
        outfile = op.join(self.savepath, '%s_config.pkl' % self.station)
        cfgio.save_config(targets, outfile, priors=self.priors,
                          initparams=self.initparams)

        self.targets = targets
        self.nchains = int(self.initparams.get('nchains'))
        self.ntargets = len(targets.targets)

        self.iter_phase1 = int(self.initparams['iter_burnin'])
        self.iter_phase2 = int(self.initparams['iter_main'])
        self.iterations = self.iter_phase1 + self.iter_phase2
        self.maxlayers = int(self.priors['layers'][1]) + 1

        # device mesh over the chain axis; say where the run goes (JAX
        # falls back to the CPU by itself when an accelerator plugin
        # fails to load)
        self.devices = devices if devices is not None else jax.devices()
        platform, kind, ndev = device.describe(self.devices)
        logger.info('> Devices: platform %s, %s x %d.'
                    % (platform, kind, ndev))
        device.enable_compile_cache()

        noiserefs = [t.noiseref for t in targets.targets]
        self.cfg = make_config(self.priors, self.initparams, noiserefs,
                               nl=self.maxlayers, dtype=dtype)
        self.eval_fn = build_evaluator(targets, self.priors,
                                       self.initparams, self.maxlayers,
                                       dtype=dtype)
        self.mesh = Mesh(np.array(self.devices), ('chains',))
        self.sharding = NamedSharding(self.mesh, P('chains'))
        # multi-device: shard_map the dispatch programs over the chain
        # mesh (each shard's root-search loops then stop on their own;
        # see build_sampler)
        self.sampler = build_sampler(
            self.eval_fn, self.cfg,
            mesh=self.mesh if len(self.devices) > 1 else None)
        (self.init_fn, self.iterate_fn, self.run_fn,
         self.snapshot_fn) = (self.sampler.init_fn,
                              self.sampler.iterate_fn,
                              self.sampler.run_fn,
                              self.sampler.snapshot_fn)

        # optional parallel tempering (sampler/tempering.py, beyond
        # the reference): ``nchains`` keeps its reference meaning —
        # the number of POSTERIOR (beta=1) chains — and each cold
        # chain gets ntemps-1 heated replicas on the same batch axis
        self.ntemps = int(self.initparams.get('ntemps', 1))
        self.tempering_plan = None

        # pad chain count to the device count (and to whole
        # temperature groups, so replica-exchange pairs never span a
        # partial group)
        ndev = len(self.devices)
        unit = ndev * self.ntemps // np.gcd(ndev, self.ntemps)
        total = self.nchains * self.ntemps
        self.nchains_padded = int(np.ceil(total / unit) * unit)
        if self.nchains_padded != total:
            logger.info('> Padding %d chains to %d for %d devices.'
                        % (total, self.nchains_padded, ndev))

        if self.ntemps > 1:
            from bayhunter_jax.sampler import tempering
            self.sampler, self.tempering_plan = tempering.attach(
                self.sampler, self.nchains_padded, self.ntemps,
                tmax=float(self.initparams.get('tmax', 1000.0)),
                swap_every=int(self.initparams.get('swap_every', 1)),
                dtype=dtype)
            # burn-in ladder adaptation toward equal adjacent swap
            # rates (frozen for the main phase); see tempering.
            # adapt_ladder
            self._ladder_adapt = bool(
                self.initparams.get('adapt_ladder', True))
            self._ladder_rung_betas = None   # lazily from states.beta
            self._ladder_prev = None
            self._ladder_nupd = 0
            logger.info(
                '> Parallel tempering: %d rungs (tmax %.1f), swap '
                'sweep every %d cycles%s.'
                % (self.ntemps, self.tempering_plan.tmax,
                   self.tempering_plan.swap_every,
                   ', burn-in ladder adaptation on'
                   if self._ladder_adapt else ''))

        # chain resort (initparams['resort_chains']): sort rows by
        # layer count between segments (chain.resort_states — a pure
        # relabeling; the reference output contract is restored
        # through self._perm at snapshot/checkpoint time).  Sharded
        # batches sort within each device's shard (chains never
        # migrate between devices).  It was made for per-tile layer
        # skips in removed hand-written kernels; the plain path has
        # no tiles, so its effect here is unmeasured.  It costs one
        # small program per segment.
        self._resort = bool(self.initparams.get('resort_chains',
                                                True))
        self._perm = None

        logger.info('> %d chain(s) are initiated on %d device(s)...'
                    % (self.nchains, ndev))


    # ------------------------------------------------------------------

    def _init_states(self):
        betas = None if self.tempering_plan is None \
            else self.tempering_plan.betas
        states = self.sampler.init_states_host(self.seed,
                                               self.nchains_padded,
                                               betas=betas)
        return jax.device_put(states, self.sharding)

    def _phase_plan(self, niter):
        """(thin, n_snap, remainder) so that n_snap <= maxmodels and
        n_snap*thin + remainder == niter."""
        maxmodels = int(self.initparams['maxmodels'])
        if niter <= 0:
            return 1, 0, 0
        thin = int(np.ceil(niter / maxmodels))
        n_snap = niter // thin
        rem = niter - n_snap * thin
        return thin, n_snap, rem

    def _snapshot_host(self, states):
        """Record the current per-chain state in the reference's save
        layout (src/SingleChain.py:665-690) — cheap host pull of the
        small state arrays."""
        vs, z, n, logL, misfits, noise, vpvs = jax.device_get(
            (states.vs, states.z, states.n, states.logL,
             states.misfits, states.noise, states.vpvs))
        if self._perm is not None:
            # undo the resort relabeling: row -> original chain id
            inv = np.argsort(np.asarray(jax.device_get(self._perm)))
            vs, z, n, logL, misfits, noise, vpvs = (
                arr[inv] for arr in (vs, z, n, logL, misfits, noise,
                                     vpvs))
        if self.tempering_plan is not None:
            # posterior = the beta=1 rung of every temperature group
            cold = self.tempering_plan.cold_indices(self.nchains_padded)
            vs, z, n, logL, misfits, noise, vpvs = (
                arr[cold] for arr in (vs, z, n, logL, misfits, noise,
                                      vpvs))
        nl = vs.shape[-1]
        mask = np.arange(nl)[None, :] < n[:, None]
        vs_p = np.where(mask, vs, np.nan)
        z_p = np.where(mask, z, np.nan)
        return dict(model=np.concatenate([vs_p, z_p], axis=1),
                    logL=logL, misfits=misfits, noise=noise, vpvs=vpvs)

    def _run_phase(self, states, niter, label, baywatch_pub=None,
                   dtsend=0.5, t0=None, phase_id=1, start_it=0,
                   parts=None):
        """Run one phase in fixed-size device segments with host-side
        snapshot collection every ``thin`` iterations; returns
        (states, snapshots dict of stacked (chains, n_snap, ...)
        arrays).

        Segment size is calibrated ONCE (a second compile at most) to
        ``segment_seconds`` per device call — long calls delay
        progress logs and checkpoints, short ones waste dispatch.  A
        checkpoint is
        written every ``checkpoint_seconds`` (0 disables)."""
        thin, n_snap, rem = self._phase_plan(niter)
        if n_snap == 0:
            return states, None
        total = n_snap * thin + rem

        target_s = float(self.initparams.get('segment_seconds', 5.0))
        ckpt_s = float(self.initparams.get('checkpoint_seconds', 600.0))
        # segment_iters pins the device-segment size (skipping the
        # wall-time calibration): the per-step remainder of a segment
        # not aligned to whole cycles follows the random-scan schedule
        # instead of the fused cycle order, so two runs are
        # move-sequence-identical ONLY with equal segmentation — pin
        # it for A/B comparisons (e.g. resort_chains validation)
        seg_pin = int(self.initparams.get('segment_iters', 0))
        seg = seg_pin if seg_pin > 0 else int(min(50, total))
        parts = list(parts) if parts else []
        it_done = start_it
        next_snap = thin * (len(parts) + 1)
        next_log = 0
        calibrated = False
        last_send = 0.0
        last_ckpt = time.time()
        step_fn = self.sampler.step_fn
        clen = max(self.sampler.cycle_len, 1)
        # fused cycles (ONE program per sweep over the move set)
        # amortize the per-program dispatch cost; fall back to
        # per-step dispatch when the snapshot stride is finer than a
        # cycle (tiny test runs) so snapshots stay distinct states
        # initparams['fused_cycles']=False forces the per-step
        # random-scan schedule — slower, but the comparator for A/B
        # validation of the fused systematic-scan cycles
        use_cycles = (self.sampler.cycle_fn is not None
                      and thin >= clen
                      and bool(self.initparams.get('fused_cycles',
                                                   True)))
        if use_cycles and not getattr(self, '_precompiled', False):
            # concurrent AOT compile of all cycle variants (see
            # chain.precompile_cycles)
            self._precompiled = True
            precompile_cycles(self.sampler, states)
        it_global = int(np.asarray(jax.device_get(states.iiter))[0])
        while it_done < total:
            step = min(seg, total - it_done)
            t_seg = time.time()
            if use_cycles:
                states = dispatch_cycles(self.sampler, states,
                                         it_global, step)
            else:
                # host-dispatched iterations: the per-iteration move
                # id is a static argument, one specialized program per
                # move type
                moves = self.sampler.moves_for(it_global, step)
                for i, m in enumerate(moves):
                    states = step_fn(states, int(m))
                    if (i & 15) == 15:
                        jax.block_until_ready(states.logL)
            jax.block_until_ready(states.logL)
            dt_seg = time.time() - t_seg
            it_done += step
            it_global += step

            if (phase_id == 1 and self.tempering_plan is not None
                    and getattr(self, '_ladder_adapt', False)):
                states = self._maybe_adapt_ladder(states)

            if self._resort:
                if self._perm is None:
                    self._perm = jax.device_put(
                        jnp.arange(self.nchains_padded,
                                   dtype=jnp.int32),
                        self.sharding)
                states, self._perm = resort_states(
                    states, self._perm, self.ntemps,
                    self.mesh if len(self.devices) > 1 else None)

            if not calibrated and step == seg and seg_pin <= 0:
                calibrated = True
                seg_new = int(np.clip(seg * target_s / max(dt_seg, 1e-3),
                                      1, 2000))
                if seg_new > 2 * seg or seg_new < seg // 2:
                    seg = seg_new

            while it_done >= next_snap and len(parts) < n_snap:
                parts.append(self._snapshot_host(states))
                next_snap += thin

            if it_done >= next_log or it_done >= total:
                next_log += max(thin * 10, 5000)
                snap = parts[-1] if parts else self._snapshot_host(states)
                logL = snap['logL'][:self.nchains]
                misf = snap['misfits'][:self.nchains, -1]
                # layer count + acceptance rate, like the reference's
                # per-5000 progress line (src/SingleChain.py:570-582)
                nlay = np.isfinite(
                    snap['model'][:self.nchains, :self.maxlayers]
                ).sum(axis=1)
                acc, prop, ffail = jax.device_get(
                    (states.accepted, states.proposed, states.fwdfail))
                if self.tempering_plan is not None:
                    cold = self.tempering_plan.cold_indices(
                        self.nchains_padded)
                    acc, prop, ffail = acc[cold], prop[cold], \
                        ffail[cold]
                acc_rate = 100.0 * acc[:self.nchains].sum() \
                    / max(prop[:self.nchains].sum(), 1)
                # forward-failure (solver sentinel) rejection rate — a
                # misconfigured propdist that inflates solve failures
                # must surface here, not silently bias acceptance.
                # Slot 2 is the dimension (birth/death) slot, where
                # root shifts concentrate.
                ff = ffail[:self.nchains]
                pp = prop[:self.nchains]
                ffail_rate = 100.0 * ff.sum() / max(pp.sum(), 1)
                ffail_dim = 100.0 * ff[:, 2].sum() / max(
                    pp[:, 2].sum(), 1)
                runtime = time.time() - (t0 or time.time())
                swap_info = ''
                if self.tempering_plan is not None:
                    sacc, sprop = jax.device_get(
                        (states.swap_accepted, states.swap_proposed))
                    swap_info = ' | %4.1f%% swap' % (
                        100.0 * sacc.sum() / max(sprop.sum(), 1))
                logger.info(
                    '%s %7d/%d it | %4.1f lay | logL med %9.1f | '
                    'joint misfit med %8.3f | %4.1f%% acc | '
                    '%4.2f%% fwd-rej (dim %4.2f%%)%s | %6.1f s '
                    '| %6.0f prop/s'
                    % (label, it_done, total, float(np.median(nlay)),
                       float(np.median(logL)), float(np.median(misf)),
                       acc_rate, ffail_rate, ffail_dim, swap_info,
                       runtime,
                       self.nchains * step / max(dt_seg, 1e-9)))
                if ffail_dim > 20.0:
                    logger.warning(
                        '> %4.1f%% of dimension proposals rejected by '
                        'forward-solve failure — check propdist.'
                        % ffail_dim)
            if baywatch_pub is not None \
                    and time.time() - last_send > dtsend:
                self._publish(baywatch_pub,
                              parts[-1] if parts
                              else self._snapshot_host(states))
                last_send = time.time()

            if ckpt_s > 0 and time.time() - last_ckpt > ckpt_s \
                    and it_done < total:
                self.save_checkpoint(states, phase_id, it_done, parts)
                last_ckpt = time.time()
                logger.info('> checkpoint written (%s, %d/%d it)'
                            % (label.strip(), it_done, total))

        # stack snapshots to (chains, n_snap, ...)
        snapshots = {k: np.stack([p[k] for p in parts], axis=1)
                     for k in parts[0]}
        return states, snapshots

    def _maybe_adapt_ladder(self, states):
        """One burn-in ladder-adaptation step: nudge the temperature
        gaps toward equal adjacent swap rates (tempering.adapt_ladder)
        once every gap has accumulated enough windowed proposals.
        Returns the (possibly beta-updated) states."""
        from bayhunter_jax.sampler import tempering as tp
        plan = self.tempering_plan
        acc, prop = jax.device_get(
            (states.swap_accepted, states.swap_proposed))
        rates, nprop = tp.rung_swap_rates(acc, prop, plan.ntemps,
                                          prev=self._ladder_prev)
        if nprop.min() < 64:
            return states
        if self._ladder_rung_betas is None:
            # from the live state, so a resumed run continues its own
            # (possibly already adapted) ladder
            self._ladder_rung_betas = np.asarray(
                jax.device_get(states.beta[:plan.ntemps]), float)
        self._ladder_prev = (acc, prop)
        self._ladder_nupd += 1
        step = 0.6 / (1.0 + self._ladder_nupd / 10.0)
        self._ladder_rung_betas = tp.adapt_ladder(
            self._ladder_rung_betas, rates, step)
        betas = np.tile(self._ladder_rung_betas,
                        self.nchains_padded // plan.ntemps)
        self.tempering_plan = plan._replace(betas=betas)
        new_beta = jax.device_put(
            jnp.asarray(betas, states.beta.dtype),
            states.beta.sharding)
        logger.debug('> ladder adapted (update %d): swap rates %s, '
                     'betas %s'
                     % (self._ladder_nupd,
                        np.round(rates, 2).tolist(),
                        np.round(self._ladder_rung_betas,
                                 4).tolist()))
        return states._replace(beta=new_beta)

    def _publish(self, socket, snaps):
        """Latest-state telemetry in the reference BayWatch wire layout
        (reference: src/mcmcOptimizer.py:140-200): three arrays —
        [vpvs | model], likes, noise."""
        C = self.nchains
        models = np.asarray(snaps['model'])[:C, :].astype(np.float32)
        vpvs = np.asarray(snaps['vpvs'])[:C, None].astype(np.float32)
        likes = np.asarray(snaps['logL'])[:C, None].astype(np.float32)
        noise = np.asarray(snaps['noise'])[:C, :].astype(np.float32)
        socket.send_array(np.concatenate((vpvs, models), axis=1))
        socket.send_array(likes)
        socket.send_array(noise)

    # ------------------------------------------------------------------
    # checkpoint / resume — the full sampler state is one pytree, so a
    # checkpoint is a flat npz of its leaves plus phase bookkeeping
    # (the reference cannot resume at all; SURVEY.md §5)
    # ------------------------------------------------------------------

    @property
    def ckptfile(self):
        return op.join(self.savepath, 'checkpoint.npz')

    def save_checkpoint(self, states, phase, it_done, parts):
        leaves = jax.tree_util.tree_leaves(jax.device_get(states))
        payload = {'leaf_%d' % i: np.asarray(v)
                   for i, v in enumerate(leaves)}
        payload['phase'] = np.asarray(phase)
        payload['it_done'] = np.asarray(it_done)
        payload['n_parts'] = np.asarray(len(parts))
        if self._perm is not None:
            # states rows are resort-relabeled; the perm restores the
            # reference per-chain output identity on resume
            payload['perm'] = np.asarray(jax.device_get(self._perm))
        for i, p in enumerate(parts):
            for key, v in p.items():
                payload['part%d_%s' % (i, key)] = v
        tmpfile = self.ckptfile + '.tmp.npz'
        np.savez(tmpfile, **payload)
        os.replace(tmpfile, self.ckptfile)

    def load_checkpoint(self):
        """Returns (states, phase, it_done, parts) or None."""
        if not op.exists(self.ckptfile):
            return None
        data = np.load(self.ckptfile, allow_pickle=False)
        template = self.sampler.init_states_host(0, self.nchains_padded)
        treedef = jax.tree_util.tree_structure(template)
        nleaves = len(jax.tree_util.tree_leaves(template))
        n_saved = sum(1 for k in data.files if k.startswith('leaf_'))
        if n_saved != nleaves:
            raise RuntimeError(
                'checkpoint %s has %d state leaves but this build '
                'expects %d — the sampler state layout changed '
                '(e.g. the forward-cache entries); delete the '
                'checkpoint to restart the run'
                % (self.ckptfile, n_saved, nleaves))
        leaves = [jnp.asarray(data['leaf_%d' % i])
                  for i in range(nleaves)]
        states = jax.tree_util.tree_unflatten(treedef, leaves)
        states = jax.device_put(states, self.sharding)
        if 'perm' in data:
            # restore the resort relabeling map even if resort_chains
            # is now off — snapshots must keep un-permuting rows saved
            # by the previous (resorting) run
            self._perm = jnp.asarray(data['perm'], jnp.int32)
        parts = []
        keys = ('model', 'logL', 'misfits', 'noise', 'vpvs')
        for i in range(int(data['n_parts'])):
            parts.append({k: data['part%d_%s' % (i, k)] for k in keys})
        return states, int(data['phase']), int(data['it_done']), parts

    # ------------------------------------------------------------------

    def mp_inversion(self, nthreads=0, baywatch=False, dtsend=0.5,
                     resume=False):
        """Run the full inversion.  ``nthreads`` is accepted for
        reference API compatibility and ignored (chains run as one
        batched device program).  With ``resume=True`` an existing
        ``checkpoint.npz`` in the savepath continues a previous run."""
        t0 = time.time()

        socket = None
        if baywatch:
            try:
                import zmq
                from bayhunter_jax.utils import SerializingContext
                context = SerializingContext()
                socket = context.socket(zmq.PUB)
                socket.bind(self.sock_addr)
                logger.info('Starting BayWatch publisher on %s...'
                            % self.sock_addr)
            except Exception as exc:  # pragma: no cover
                logger.warning('BayWatch publisher unavailable: %s' % exc)

        ckpt = self.load_checkpoint() if resume else None
        if ckpt is not None:
            states, phase0, it0, parts0 = ckpt
            logger.info('> Resuming from checkpoint: phase %d, '
                        '%d iterations done.' % (phase0, it0))
        else:
            states = self._init_states()
            phase0, it0, parts0 = 1, 0, []

        if phase0 <= 1:
            states, p1 = self._run_phase(
                states, self.iter_phase1, 'burn-in', baywatch_pub=socket,
                dtsend=dtsend, t0=t0, phase_id=1, start_it=it0,
                parts=parts0)
            self._save_phase(p1, 'p1')
            it0, parts0 = 0, []
        states, p2 = self._run_phase(
            states, self.iter_phase2, 'main   ', baywatch_pub=socket,
            dtsend=dtsend, t0=t0, phase_id=2, start_it=it0,
            parts=parts0)
        self._save_phase(p2, 'p2')
        if op.exists(self.ckptfile):
            os.remove(self.ckptfile)

        # positive convergence evidence over the main-phase traces
        # (beyond the reference's outlier pruning): split-R-hat + ESS
        # of the pooled likelihood trace (diagnostics.py)
        if p2 is not None and p2['logL'].shape[1] >= 4:
            from bayhunter_jax import diagnostics
            rep = diagnostics.convergence_report(
                {'logL': p2['logL'][:self.nchains]})['logL']
            logger.info(
                '> convergence: logL split-R-hat %.4f, ESS %.0f '
                '(%.1f/chain)%s'
                % (rep['rhat'], rep['ess'], rep['ess_per_chain'],
                   '' if rep['converged']
                   else ' — R-hat > 1.01: chains disagree, consider '
                        'longer burn-in or parallel tempering'))

        self.final_states = states
        runtime = time.time() - t0
        total_props = self.iterations * self.nchains
        logger.info('> All chains terminated after: %.5f s' % runtime)
        logger.info('### time for inversion: %.2f s (%.0f proposals/s '
                    'aggregate)' % (runtime, total_props / runtime))
        if socket is not None:
            time.sleep(2 * dtsend)
            socket.close()
        return runtime

    def _save_phase(self, snaps, tag):
        """Write the reference's per-chain .npy contract
        (reference: src/SingleChain.py:665-690)."""
        if snaps is None:
            return
        names = {'model': 'models', 'logL': 'likes',
                 'misfits': 'misfits', 'noise': 'noise', 'vpvs': 'vpvs'}
        for c in range(self.nchains):
            for key, name in names.items():
                arr = np.asarray(snaps[key][c], np.float32)
                outfile = op.join(self.savepath,
                                  'c%.3d_%s%s' % (c, tag, name))
                np.save(outfile, arr)
        nmodels = snaps['logL'].shape[1]
        logger.info('> Saving %d models (%s phase) for %d chains.'
                    % (nmodels, tag, self.nchains))
