"""Template: a user-defined target.

Mirrors the reference extension point (reference:
templates/mytarget.py:13-25): subclass ``SingleTarget`` with a unique
``ref`` string and a ``noiseref`` of 'swd' or 'rf' (it selects which
noise-prior family — <noiseref>noise_corr / <noiseref>noise_sigma —
applies to this target).
"""

from bayhunter_jax.Targets import SingleTarget


class MyOwnTarget(SingleTarget):
    noiseref = 'swd'  # or 'rf': selects the noise hyperparameter priors

    def __init__(self, x, y, yerr=None):
        ref = 'myref'  # unique identifier; also used in output files
        SingleTarget.__init__(self, x, y, ref, yerr=yerr)
        # attach your forward plugin (see myfwd.py):
        # self.update_plugin(MyForwardModel(x, ref))
