"""What the benchmark loads: no module whose top-level name is `jax`,
`jaxlib`, `flax` or `triple_accel_tpu` (names compared whole: the port's
own name begins with the JAX package's), and a reference that loads
nothing of the port."""

import json
import os
import subprocess
import sys

from portbench.harness import FORBIDDEN_MODULES, ROOT

PROBE = """
import json, sys
sys.path.insert(0, {root!r})
{body}
print(json.dumps(sorted({{n.split('.', 1)[0] for n in sys.modules}})))
"""


def _tops(body: str):
    p = subprocess.run([sys.executable, "-c",
                        PROBE.format(root=ROOT, body=body)],
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert p.returncode == 0, p.stderr
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_reference_loads_nothing_of_the_port():
    tops = _tops("import portbench.reference.distance, "
                 "portbench.reference.search, portbench.metrics.cost_model")
    assert not tops & set(FORBIDDEN_MODULES)
    assert "triple_accel_tpu_torch" not in tops


def test_a_whole_run_loads_no_jax():
    body = ("import torch; torch.set_num_threads(1)\n"
            "from portbench.harness import run_cell\n"
            "from portbench.tests.tiny import tiny_cell\n"
            "for n in ('wfa10k.exact', 'acgt47m.longread'):\n"
            "    r = run_cell(tiny_cell(n), 3, 0.2, True, device='cpu',\n"
            "                 emit=lambda s: None)\n"
            "    assert r['correct']\n")
    tops = _tops(body)
    assert "triple_accel_tpu_torch" in tops
    assert not tops & set(FORBIDDEN_MODULES), tops & set(FORBIDDEN_MODULES)
