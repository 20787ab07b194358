"""Configuration loading/saving with reference-compatible semantics.

Mirrors the INI contract of the reference implementation
(reference: src/utils.py:44-171): two sections, ``[modelpriors]`` and
``[initparams]``; every value is Python-eval'd (so ``1.5, 2.1`` becomes a
tuple, ``(2048 * 2)`` an int, ``None`` stays None) except the string
keywords ``station`` and ``savepath``.  A scalar prior fixes the
parameter, a 2-tuple makes it a uniform prior that is inverted for
(reference: src/SingleChain.py:137-157).

Implemented on top of :mod:`configparser` (the reference used
``configobj``, which is not required here).
"""

import configparser
import os.path as op
import pickle

STRING_KEYWORDS = ('station', 'savepath')


def _decode_value(key, raw):
    raw = raw.strip()
    if key in STRING_KEYWORDS:
        # allow both quoted ('test') and bare (test) strings
        try:
            val = eval(raw, {}, {})
            return val if isinstance(val, str) else raw
        except Exception:
            return raw
    try:
        return eval(raw, {}, {})
    except Exception:
        # comma separated list of expressions
        parts = [p for p in raw.split(',') if p.strip()]
        try:
            return [eval(p, {}, {}) for p in parts]
        except Exception:
            return raw


def _decode_section(section):
    return {key: _decode_value(key, raw) for key, raw in section.items()}


def load_params(initfile):
    """Return ``[priors_dict, initparams_dict]`` from an INI file.

    Reference: src/utils.py:58-68.  Sections named ``datapaths`` are
    skipped (they belong to the station-path loader).
    """
    cp = configparser.ConfigParser(inline_comment_prefixes=('#', ';'),
                                   interpolation=None)
    cp.optionxform = str  # preserve key case
    read = cp.read(initfile)
    if not read:
        raise OSError('could not read config file: %s' % initfile)
    params = []
    for name in cp.sections():
        if name == 'datapaths':
            continue
        params.append(_decode_section(cp[name]))
    return params


def load_params_user(initfile, station, slowness=7):
    """Station-oriented loader with a ``[datapaths]`` section.

    Reference: src/utils.py:71-99.  Returns (paths, modelpriors,
    initparams); receiver-function files carry their slowness in a
    ``#``-comment on line 2.
    """
    import linecache
    cp = configparser.ConfigParser(inline_comment_prefixes=(';',),
                                   interpolation=None)
    cp.optionxform = str
    if not cp.read(initfile):
        raise OSError('could not read config file: %s' % initfile)

    paths = {}
    if cp.has_section('datapaths'):
        for key, template in cp['datapaths'].items():
            template = template.strip().strip('\'"')
            if key.split('.')[-1] == 'bin':
                fn = template % (station, slowness)
            else:
                fn = template % station
            if op.exists(fn):
                newkey = key.split('_')[-1]
                paths[newkey] = fn
                if key.split('.')[-1] in ('bin', 'stack'):
                    slow = float(
                        linecache.getline(fn, 2).strip().replace('#', ''))
                    paths['slowness.%s' % key.split('.')[-1]] = slow

    modelpriors = _decode_section(cp['modelpriors'])
    initparams = _decode_section(cp['initparams'])
    initparams['station'] = station
    initparams['savepath'] = initparams['savepath'] % (station, '%.2f')
    return paths, modelpriors, initparams


def get_path(name):
    """Locate a file shipped in ``bayhunter_jax/defaults``.

    Reference: src/utils.py:167-171.
    """
    fn = op.join(op.dirname(__file__), 'defaults', name)
    if not op.exists(fn):
        raise OSError('%s does not exist!' % name)
    return fn


def save_config(targets, configfile, priors=dict(), initparams=dict()):
    """Pickle targets + parameter dicts for post-hoc plotting.

    Reference: src/utils.py:127-153.  Covariance closures are nulled
    before pickling, as in the reference.
    """
    data = {}
    refs = []
    for target in targets.targets:
        target.get_covariance = None
        refs.append(target.ref)
    data['targets'] = targets.targets
    data['targetrefs'] = refs
    data['priors'] = priors
    data['initparams'] = initparams
    with open(configfile, 'wb') as f:
        pickle.dump(data, f)


def save_baywatch_config(targets, path='.', priors=dict(), initparams=dict(),
                         refmodel=dict()):
    """Save the configfile consumed by BayWatch.

    Reference: src/utils.py:102-124.
    """
    configfile = op.join(path, 'baywatch.pkl')
    data = {}
    for target in targets.targets:
        target.get_covariance = None
    data['targets'] = targets.targets
    data['priors'] = priors
    data['initparams'] = initparams
    data['refmodel'] = refmodel
    with open(configfile, 'wb') as f:
        pickle.dump(data, f)


def read_config(configfile):
    """Load a pickled config file.  Reference: src/utils.py:156-164."""
    with open(configfile, 'rb') as f:
        try:
            return pickle.load(f)
        except UnicodeDecodeError:
            f.seek(0)
            return pickle.load(f, encoding='latin1')
