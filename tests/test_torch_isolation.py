"""The port imports no JAX and nothing of the JAX package.

In a fresh interpreter, an import hook refuses jax, jaxlib, flax, optax,
chex, msgpack, tensorboardX and active_tracking_rl_tpu; then every module of
active_tracking_rl_torch and chip_smoke.py are imported, and the JAX env
package's public names (``API``) are looked up in the port's modules of the
same path. The card's machine
has none of those packages, so an import of one would fail there.
"""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

SCRIPT = r"""
import importlib
import importlib.abc
import pkgutil
import sys

BANNED = ("jax", "jaxlib", "flax", "optax", "chex", "msgpack", "tensorboardX",
          "active_tracking_rl_tpu")


class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BANNED:
            raise ImportError(f"the port imported {name}")
        return None


sys.meta_path.insert(0, Refuse())
for name in list(sys.modules):
    if name.split(".")[0] in BANNED:
        raise SystemExit(f"{name} was imported before the hook")

import active_tracking_rl_torch

names = ["chip_smoke"] + [
    m.name for m in pkgutil.walk_packages(active_tracking_rl_torch.__path__,
                                          "active_tracking_rl_torch.")]
for name in names:
    importlib.import_module(name)
# the JAX env package's public names, each in the port's module of its path
for mod, attr in API:
    getattr(importlib.import_module("active_tracking_rl_torch." + mod), attr)
print(len(names), "modules", *names)
"""

API = (("envs", "make_env"), ("envs", "TrackEnv"), ("envs", "EnvState"),
       ("envs.env", "make_env"), ("envs.types", "zeros_like_state"),
       ("envs.distance", "distance_field"),
       ("envs.distance", "distance_field_sweep"))


def test_port_and_smoke_import_no_jax():
    res = subprocess.run([sys.executable, "-c",
                          f"API = {API!r}\n" + SCRIPT], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    out = res.stdout.split()
    assert int(out[0]) > 20
    for name in ("rl.curriculum", "rl.evaluate", "models.dueling",
                 "ops.flood", "rl.checkpoint", "run.train", "run.eval",
                 "run.eval_matrix", "utils.flax_msgpack", "utils.logging",
                 "utils.stats", "envs.bridge", "envs.render", "rl.host_loop",
                 "run.train_host", "run.random_agent", "run.demo",
                 "run.parity", "run.profile_summary", "parallel.mesh",
                 "parallel.mp_check", "parallel.scaling", "utils.platform",
                 "run.bench", "run.profile_iter", "run.bench_flood"):
        assert f"active_tracking_rl_torch.{name}" in out, name
