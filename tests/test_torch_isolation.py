"""carle_tpu_torch imports neither JAX nor carle_tpu.

Every module of the package (``pkgutil.walk_packages``; ``csrc/`` holds
CUDA sources and ``native/`` C++ sources beside its bindings) is imported in
a fresh interpreter whose import system refuses ``jax``, ``jaxlib`` and
``carle_tpu`` (and their submodules): each import must succeed.
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = r"""
import importlib
import json
import pkgutil
import sys

REFUSED = ("jax", "jaxlib", "carle_tpu")


class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in REFUSED:
            raise ImportError(f"refused: {name}")
        return None


sys.meta_path.insert(0, Refuse())
import carle_tpu_torch

failed = {}
names = []
for info in pkgutil.walk_packages(carle_tpu_torch.__path__, "carle_tpu_torch.",
                                  onerror=lambda name: failed.setdefault(name, "walk")):
    names.append(info.name)
    try:
        importlib.import_module(info.name)
    except Exception as exc:  # report every module that fails, not just the first
        failed[info.name] = f"{type(exc).__name__}: {exc}"
leaked = sorted(m for m in sys.modules if m.split(".")[0] in REFUSED)
print(json.dumps({"modules": names, "failed": failed, "leaked": leaked}))
"""


def test_every_module_imports_without_jax_or_carle_tpu():
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=REPO, capture_output=True,
                         text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stderr[-3000:]
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["failed"] == {} and report["leaked"] == []
    modules = set(report["modules"])
    for name in ("carle_tpu_torch.native", "carle_tpu_torch.analysis",
                 "carle_tpu_torch.demos", "carle_tpu_torch.utils.gif",
                 "carle_tpu_torch.utils.png", "carle_tpu_torch.serve",
                 "carle_tpu_torch.evaluation.eval", "carle_tpu_torch.ops.cuda_build",
                 "carle_tpu_torch.parallel.spatial_env"):
        assert name in modules, name
    assert len(modules) >= 50
