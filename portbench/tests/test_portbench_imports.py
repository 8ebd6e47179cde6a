"""Nothing the harness or the reference loads is JAX or the JAX package
(top-level names compared whole: the port's name begins with the JAX
package's), and the reference loads nothing of the port."""

import ast
import glob
import os
import subprocess
import sys

from tinycell import REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "reconstruction_tpu"}


def _loaded(code):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(sorted({m.split('.')[0] for m in sys.modules}))"],
                         cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    code = """
import glob, os
from portbench import run, spec, calibrate, compare, costs, scene, trace, metrics_inputs
from portbench.reference import take
for path in glob.glob('portbench/drivers/*.py') + glob.glob('portbench/metrics/*.py'):
    spec.load_module(os.path.abspath(path))
import reconstruction_tpu_torch.pipeline.reconstruct
"""
    assert not (_loaded(code) & FORBIDDEN)


def test_reference_loads_nothing_of_the_port():
    top = _loaded("import portbench.reference.take, portbench.reference.stereo.pipeline")
    assert not (top & (FORBIDDEN | {"reconstruction_tpu_torch"}))


def test_sources_import_no_jax():
    """Every import statement under portbench/, by top-level name."""
    for path in glob.glob(os.path.join(REPO, "portbench", "**", "*.py"), recursive=True):
        with open(path) as f:
            tree = ast.parse(f.read())
        in_reference = f"{os.sep}reference{os.sep}" in path
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
                names = [node.module]
            else:
                continue
            for n in names:
                top = n.split(".")[0]
                assert top not in FORBIDDEN, (path, n)
                if in_reference:
                    assert top != "reconstruction_tpu_torch", (path, n)
