"""The port's iteration split (active_tracking_rl_torch/run/profile_iter.py)
on the CPU at 16 envs and a pool of 8, one timed call per part: the keys
of the root profile_iter.py (and the port's pool parts), each value a
positive float (seconds per call, or steps per second). The CLI passes
its shapes and device on and prints the dict as one JSON object.
"""

import json

import tests.torch_draws  # noqa: F401  (one CPU thread for torch)
from active_tracking_rl_torch.run import profile_iter

#: the root profile_iter.py's keys
ENV_KEYS = {"train_step_s", "pool_s", "maps_s", "steps_per_s"}
CORE_KEYS = {"core_step_s", "rollout_fwd_s", "backward_s", "model_scan_s",
             "env_scan_s", "autoreset_scan_s"}
TOP_KEYS = {"BlockPartialNav", "BlockPartialRam", "core_decomposition_k16",
            "nav_tape_s", "flood_xla_s", "flood_pallas_s"}
#: the port's pool parts
POOL_PARTS = {"pool_map_s", "pool_spawns_s", "pool_tape_s"}


def _positive_float(x):
    return isinstance(x, float) and x > 0


def test_profile_iter_keys_and_values():
    out = profile_iter.profile_iter(16, 8, "cpu", iters=1, warmup=0)
    assert set(out) == TOP_KEYS
    for env in ("BlockPartialNav", "BlockPartialRam"):
        assert set(out[env]) == ENV_KEYS | POOL_PARTS, env
        assert all(_positive_float(v) for v in out[env].values()), out[env]
        assert out[env]["steps_per_s"] == 16 * 20 / out[env]["train_step_s"]
    core = out["core_decomposition_k16"]
    assert set(core) == CORE_KEYS
    assert all(_positive_float(v) for v in core.values()), core
    assert core["backward_s"] == core["core_step_s"] - core["rollout_fwd_s"]
    assert all(_positive_float(out[k]) for k in
               ("nav_tape_s", "flood_xla_s", "flood_pallas_s"))


def test_cli_passes_shapes_and_prints_one_dict(monkeypatch, capsys):
    calls = []

    def recorder(*args):
        calls.append(args)
        return {"nav_tape_s": 1.0}

    monkeypatch.setattr(profile_iter, "profile_iter", recorder)
    out = profile_iter.main(["--device", "cpu", "--num-envs", "16"])
    assert json.loads(capsys.readouterr().out) == out == {"nav_tape_s": 1.0}
    profile_iter.main(["--device", "cpu", "--num-envs", "16", "--pool", "4"])
    capsys.readouterr()
    # the pool defaults to num-envs // 8, as the JAX script's
    assert calls == [(16, 2, "cpu"), (16, 4, "cpu")]
