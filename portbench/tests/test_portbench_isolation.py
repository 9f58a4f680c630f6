"""Nothing the benchmark loads is JAX or the JAX package, and the
reference loads nothing of the port."""

import json
import subprocess
import sys

from portbench import harness

PROBE = '''
import json, sys
sys.path.insert(0, {root!r})
{imports}
print(json.dumps(sorted(sys.modules)))
'''


def _loaded(imports):
    out = subprocess.run(
        [sys.executable, '-c', PROBE.format(root=str(harness.ROOT),
                                            imports=imports)],
        capture_output=True, text=True, check=True, timeout=300)
    return {m.split('.')[0] for m in json.loads(out.stdout.splitlines()[-1])}


def test_the_harness_loads_no_jax():
    top = _loaded('import portbench.run, portbench.harness, '
                  'portbench.program, portbench.loops.serve, '
                  'portbench.loops.train, portbench.reference.piano\n'
                  'import ddsp_piano_torch.models.serving, '
                  'ddsp_piano_torch.training.trainer, '
                  'ddsp_piano_torch.parallel.mesh, ddsp_piano_torch.configs')
    assert not top & {'jax', 'jaxlib', 'flax', 'ddsp_piano_tpu'}


def test_the_reference_loads_nothing_of_the_port():
    top = _loaded('from portbench.reference import piano, configs\n'
                  'configs.get_model("maestro_v2", False, 1.0, 0, "cpu")\n'
                  'configs.get_model("dafx22", True, 1.0, 0, "cpu")')
    assert not top & {'jax', 'jaxlib', 'flax', 'ddsp_piano_tpu',
                      'ddsp_piano_torch'}
