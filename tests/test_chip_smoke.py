"""chip_smoke.py's contract where there is no GPU: it must exit
non-zero and never print the result line, and the result line it
prints on a GPU holds exactly the contract's keys."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_exits_nonzero_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS='cpu')
    r = subprocess.run([sys.executable, 'chip_smoke.py'], cwd=ROOT,
                       env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert 'no GPU' in r.stderr


def test_result_line_has_exactly_the_contract_keys():
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    line = chip_smoke.result_line('gpu', 'NVIDIA H100 80GB HBM3', 1)
    assert '\n' not in line
    obj = json.loads(line)
    assert obj == {'ok': True, 'device': {
        'platform': 'gpu', 'kind': 'NVIDIA H100 80GB HBM3', 'count': 1}}


def test_tutorial_problem_is_the_benchmark_configuration():
    """chip_smoke.py and bench.py run one problem: Rayleigh phase
    dispersion (21 periods) + P receiver function (201 samples),
    layers (1, 20), rfnoise_corr 0.98 with the rcond-truncated law."""
    sys.path.insert(0, ROOT)
    try:
        import bench
    finally:
        sys.path.remove(ROOT)
    joint, priors, initparams = bench.tutorial_problem(iters=10)
    refs = [t.ref for t in joint.targets]
    assert refs == ['rdispph', 'prf']
    assert [len(t.obsdata.x) for t in joint.targets] == [21, 201]
    assert priors['layers'] == (1, 20)
    assert priors['rfnoise_corr'] == 0.98
    assert initparams['rcond'] == 1e-5
    assert initparams['iter_burnin'] == initparams['iter_main'] == 10
