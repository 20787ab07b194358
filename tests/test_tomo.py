"""Tomography-scale batched inversion: multiple cells with DIFFERENT
true models in one chain batch, sharded over the 8 virtual CPU devices
(conftest sets xla_force_host_platform_device_count=8)."""

import numpy as np

from bayhunter_jax.parallel import TomoInversion
from bayhunter_jax.synthobs import SynthObs

PRIORS = {'vs': (2.0, 5.0), 'z': (0.0, 60.0), 'layers': (1, 6),
          'vpvs': 1.73, 'swdnoise_corr': 0.0,
          'swdnoise_sigma': (1e-4, 0.05)}
INITPARAMS = {'iter_burnin': 400, 'iter_main': 200,
              'propdist': (0.03, 0.03, 0.015, 0.005, 0.005),
              'acceptance': (40, 45), 'thickmin': 0.1}


def test_tomo_batched_cells_recover_distinct_models():
    x = np.linspace(2, 40, 12)
    # two cells with clearly different crusts: thin/fast vs thick/slow
    truths = [dict(h=np.array([10., 0.]), vs=np.array([3.4, 4.6])),
              dict(h=np.array([30., 0.]), vs=np.array([2.6, 4.2]))]
    Y = []
    rs = np.random.RandomState(0)
    for t in truths:
        _, y = SynthObs.return_swddata(t['h'], t['vs'], vpvs=1.73,
                                       x=x)['rdispph']
        Y.append(np.asarray(y) + 0.005 * rs.normal(size=x.size))
    Y = np.stack(Y)

    import jax
    tomo = TomoInversion(x, Y, ref='rdispph', chains_per_cell=8,
                         priors=PRIORS, initparams=INITPARAMS,
                         random_seed=5, devices=jax.devices('cpu')[:8])
    out = tomo.run(segment_iters=150)

    assert out['vs_median'].shape == (2, 121)
    dep = out['depth']
    # shallow structure (5 km) separates the two cells
    shallow = np.argmin(np.abs(dep - 5.0))
    v0 = out['vs_median'][0, shallow]
    v1 = out['vs_median'][1, shallow]
    assert abs(v0 - 3.4) < 0.45, v0
    assert abs(v1 - 2.6) < 0.45, v1
    # each cell's chains fit THEIR data, not the other cell's
    assert np.all(out['logL_median'] > -1e4)
