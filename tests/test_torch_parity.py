"""The port's golden-trajectory harness (``run/parity.py``) against the JAX
package's.

``rollout_trace`` given the reset draws that JAX's makes from its seed
(tests/torch_draws.py) equals JAX's ``rollout_trace`` bit for bit, on a
Nav id (scripted navigator, floods) and a Ram id; ``record`` then
``verify`` passes on the port's own trace; a trace with one observation
changed fails ``verify`` (exit code 1 from the CLI); a trace replays only
on the device type it was recorded on; and ``cross_check`` raises
ImportError where the named reference directory is absent, as JAX's does
where its reference is, and the CLI's cross-check requires ``--reference``.
"""

import jax
import numpy as np
import pytest

import tests.torch_draws  # noqa: F401  (one CPU thread for torch)
from active_tracking_rl_tpu.config import parse_env_id as jparse
from active_tracking_rl_tpu.run import parity as jparity
from active_tracking_rl_torch.run import parity
from tests.torch_draws import reset_draws

SEED, EPISODES = 1, 2


@pytest.mark.parametrize("env_id", ["Track2D-BlockPartialNav-v0",
                                    "Track2D-BlockPartialRam-v0"])
def test_rollout_trace_matches_jax(env_id):
    want = jparity.rollout_trace(env_id, SEED, EPISODES)
    key, draws = jax.random.PRNGKey(SEED), []
    for _ in range(EPISODES):
        key, k = jax.random.split(key)
        draws.append(reset_draws(jparse(env_id), k[None]))
    got = parity.rollout_trace(env_id, SEED, EPISODES, draws=draws,
                               device="cpu")
    assert set(got) == set(want)
    for k in parity.TRACE_KEYS:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert want["done"].any()


def test_record_then_verify(tmp_path, capsys):
    path = str(tmp_path / "golden.npz")
    parity.record("Track2D-EmptyPartialRam-v0", 4, path, device="cpu")
    assert parity.verify(path, device="cpu")
    assert "OK (bit-exact)" in capsys.readouterr().out


def test_tampered_trace_fails(tmp_path):
    path = str(tmp_path / "golden.npz")
    parity.record("Track2D-EmptyPartialRam-v0", 4, path, device="cpu")
    g = dict(np.load(path))
    g["obs"] = g["obs"].copy()
    g["obs"][3, 0, 0, 0] ^= 1
    bad = str(tmp_path / "bad.npz")
    np.savez_compressed(bad, **g)
    assert not parity.verify(bad, device="cpu")
    with pytest.raises(SystemExit) as e:
        parity.main(["verify", "--golden", bad, "--device", "cpu"])
    assert e.value.code == 1
    g["device_type"] = np.array("cuda")
    np.savez_compressed(bad, **g)
    with pytest.raises(ValueError, match="recorded on cuda"):
        parity.verify(bad, device="cpu")


def test_cross_check_raises_without_the_reference(tmp_path):
    with pytest.raises(ImportError, match="reference env"):
        parity.cross_check("Track2D-BlockPartialNav-v0",
                           str(tmp_path / "absent"), steps=5)
    with pytest.raises(SystemExit) as e:     # --reference is required
        parity.main(["cross-check"])
    assert e.value.code == 2
