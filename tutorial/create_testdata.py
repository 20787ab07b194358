"""Forward-model the tutorial's synthetic station "st3" (a 4-layer
crust) into observed/ — the ground-truth recovery fixture
(reference workflow: tutorial/create_testdata.py)."""

import os
import os.path as op
import sys

import numpy as np

sys.path.insert(0, op.join(op.dirname(__file__), '..'))
from bayhunter_jax import SynthObs  # noqa: E402

idx = 3
h = [5, 23, 8, 0]
vs = [2.7, 3.6, 3.8, 4.4]
vpvs = 1.73

path = op.join(op.dirname(__file__), 'observed')
os.makedirs(path, exist_ok=True)
datafile = op.join(path, 'st%d_%s.dat' % (idx, '%s'))

# surface-wave dispersion (all four target types)
sw_x = np.linspace(1, 41, 21)
swdata = SynthObs.return_swddata(h, vs, vpvs=vpvs, x=sw_x)
SynthObs.save_data(swdata, outfile=datafile)

# receiver functions (P and S)
rfdata = SynthObs.return_rfdata(h, vs, vpvs=vpvs, x=None,
                                pars={'p': 6.4})
SynthObs.save_data(rfdata, outfile=datafile)

# velocity-depth model
SynthObs.save_model(h, vs, vpvs=vpvs,
                    outfile=op.join(path, 'st%d_mod.dat' % idx))
print('wrote synthetic data for st%d to %s' % (idx, path))
