"""The port's gym bridge (``envs/bridge.py``) and renderer
(``envs/render.py``) against the JAX package's.

``GymTrackEnv`` on a Nav, a Ram and a PZR id: the same reset draws (JAX's,
re-derived from its key by tests/torch_draws.py) and 30 fixed steps give
equal obs, rewards, done and info, and equal renders. Each wrapper runs
against JAX's on the same arrays (``ImagePreprocess`` once with cv2 and once
with cv2 blocked, the numpy branch the card's machine takes); then the
``create_env`` chain, the external-env boundary and the palette.
Everything here is exact: integer grids and float32 arithmetic done the
same way on the host.
"""

import sys

import jax
import numpy as np
import pytest

import tests.torch_draws  # noqa: F401  (one CPU thread for torch)
from active_tracking_rl_tpu.config import parse_env_id as jparse
from active_tracking_rl_tpu.envs import bridge as jbridge
from active_tracking_rl_tpu.envs import render as jrender
from active_tracking_rl_torch.envs import bridge, render
from tests.torch_draws import reset_draws, torch_cfg

STEPS = 30


def _assert_info_equal(got, want):
    assert set(got) == set(want)
    for k in ("distance", "eps_len"):
        assert type(got[k]) is type(want[k]) and got[k] == want[k], k
    np.testing.assert_array_equal(got["collision"], want["collision"])
    assert got["collision"].dtype == want["collision"].dtype
    for k in ("traces", "traces_relative"):
        assert got[k] == want[k], k


@pytest.mark.parametrize("env_id", ["Track2D-BlockPartialNav-v0",
                                    "Track2D-EmptyPartialRam-v0",
                                    "Track2D-BlockPartialPZR-v0"])
def test_gym_track_env_matches_jax(env_id):
    seed = 3
    jenv = jbridge.GymTrackEnv(env_id, seed=seed)
    env = bridge.GymTrackEnv(env_id, cfg=torch_cfg(jparse(env_id)),
                             device="cpu")
    # the key JAX's reset() splits off its seed's key
    _, k = jax.random.split(jax.random.PRNGKey(seed))
    want = jenv.reset()
    got = env.reset(reset_draws(jenv.cfg, k[None]))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert env.resets == 1
    actions = np.random.RandomState(0).randint(0, 4, (STEPS, 2))
    for t, a in enumerate(actions):
        w_obs, w_rew, w_done, w_info = jenv.step(list(a))
        g_obs, g_rew, g_done, g_info = env.step(list(a))
        np.testing.assert_array_equal(g_obs, w_obs, err_msg=f"obs {t}")
        assert g_rew.dtype == np.float32 and g_rew.shape == w_rew.shape
        np.testing.assert_array_equal(g_rew, w_rew, err_msg=f"rewards {t}")
        assert g_done is w_done, t
        _assert_info_equal(g_info, w_info)
    np.testing.assert_array_equal(env.render("rgb_array"),
                                  jenv.render("rgb_array"))
    assert env.render("ansi") == jenv.render("ansi")


def test_gym_track_env_seed_and_generator():
    """seed() sets every later reset's draws; resets are counted."""
    env_id = "Track2D-EmptyPartialRam-v0"
    a = bridge.GymTrackEnv(env_id, seed=5, device="cpu")
    b = bridge.GymTrackEnv(env_id, device="cpu")
    b.seed(5)
    for _ in range(2):
        np.testing.assert_array_equal(a.reset(), b.reset())
        for _ in range(3):
            np.testing.assert_array_equal(a.step([1, 0])[0],
                                          b.step([1, 0])[0])
    assert a.resets == b.resets == 2
    with pytest.raises(RuntimeError, match="reset"):
        bridge.GymTrackEnv(env_id, device="cpu").step([0, 0])


class _FakeEnv:
    """A 2-agent env whose images change every call, deterministically."""

    def __init__(self, shape=(10, 8, 3), scale=255.0):
        self.shape, self.scale, self.calls = shape, scale, 0

    def _obs(self):
        self.calls += 1
        rng = np.random.RandomState(self.calls)
        return [(rng.rand(*self.shape) * self.scale).astype(np.float32)
                for _ in range(2)]

    def reset(self):
        return self._obs()

    def step(self, action):
        return self._obs(), np.asarray(action, np.float32), False, {}


def _run_pair(make, steps=3):
    """reset + `steps` steps of the port's wrapper of `make`, then of JAX's,
    each on a fresh _FakeEnv: the outputs are equal."""
    def run(mod):
        env = make(mod, _FakeEnv())
        outs = [(env.reset(), None, None)]
        for i in range(steps):
            outs.append(env.step([i, i + 1])[:3])
        return outs

    for g, w in zip(run(bridge), run(jbridge)):
        assert g[2] == w[2]
        for x, y in zip(g[:2], w[:2]):
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("inv", [False, True])
def test_rescale_matches_jax(inv):
    def make(mod, env):
        np.random.seed(0)        # the --inv sign (-1 here) draws from numpy
        return mod.Rescale(env, inv=inv)
    _run_pair(make, steps=4)


@pytest.mark.parametrize("gray", [False, True])
@pytest.mark.parametrize("cv2", ["installed", "blocked"])
def test_image_preprocess_matches_jax(monkeypatch, gray, cv2):
    if cv2 == "blocked":
        monkeypatch.setitem(sys.modules, "cv2", None)   # import raises
    else:
        pytest.importorskip("cv2")
    _run_pair(lambda mod, env: mod.ImagePreprocess(
        mod.Rescale(env), input_size=32, gray=gray))


def test_frame_stack_and_listspace_match_jax():
    _run_pair(lambda mod, env: mod.FrameStack(env, stack_frames=3), steps=4)

    class Single:
        def __init__(self):
            self.t = 0

        def reset(self):
            return np.full((4, 4), self.t, np.float32)

        def step(self, a):
            self.t += 1
            return np.full((4, 4), self.t + a, np.float32), 0.5 * a, \
                self.t > 2, {}

    got, want = bridge.ListSpace(Single()), jbridge.ListSpace(Single())
    np.testing.assert_array_equal(got.reset(), want.reset())
    for a in (1, 2, 3):
        g, w = got.step([a]), want.step([a])
        np.testing.assert_array_equal(g[0], w[0])
        assert g[1].dtype == w[1].dtype
        np.testing.assert_array_equal(g[1], w[1])
        assert g[2] == w[2]


def test_create_env_chain_matches_jax():
    """The same wrapper chain, shapes and dtypes for every switch."""
    env_id = "Track2D-BlockPartialAdv-v0"
    for kw in (dict(stack_frames=2), dict(single=True, rescale=True),
               dict(rescale=True, inv=True, stack_frames=3)):
        got = bridge.create_env(env_id, seed=1, device="cpu", **kw)
        want = jbridge.create_env(env_id, seed=1, **kw)
        chain_g, chain_w = [], []
        for env, chain in ((got, chain_g), (want, chain_w)):
            while hasattr(env, "env"):
                chain.append(type(env).__name__)
                env = env.env
            chain.append(type(env).__name__)
        assert chain_g == chain_w
        g, w = got.reset(), want.reset()
        assert g.shape == w.shape and g.dtype == w.dtype
        if not kw.get("single"):
            g, w = got.step([0, 1]), want.step([0, 1])
            assert g[0].shape == w[0].shape and g[1].shape == w[1].shape


def test_external_env_boundary():
    with pytest.raises(ImportError, match="gym_unrealcv"):
        bridge.create_env("UnrealTrack-General-v0")
    with pytest.raises(ImportError, match="gym_unrealcv"):
        bridge.make_external_env("UnrealTrack-DuelingRoomPZR-v0")
    with pytest.raises(ValueError, match="unknown external"):
        bridge.make_external_env("CartPole-v1")


def test_host_env_pool_counts_resets():
    pool = bridge.HostEnvPool([
        (lambda i=i: bridge.GymTrackEnv("Track2D-EmptyPartialRam-v0",
                                        seed=i, device="cpu"))
        for i in range(2)])
    obs = pool.reset()
    assert obs.shape == (2, 2, 1, 13, 13) and pool.resets == 2
    done_total = 0
    for _ in range(40):
        obs, rew, done, infos = pool.step(np.zeros((2, 2), np.int64))
        assert rew.shape == (2, 2) and done.dtype == bool
        done_total += int(done.sum())
    assert done_total > 0
    assert pool.resets == 2 + done_total
    assert pool.resets == sum(e.resets for e in pool.envs)


def test_palette_and_glyphs_match_jax():
    grid = np.arange(8, dtype=np.uint8).reshape(2, 4) % 7
    np.testing.assert_array_equal(render.to_rgb(grid), jrender.to_rgb(grid))
    assert render.to_ansi(grid) == jrender.to_ansi(grid)
    env = bridge.GymTrackEnv("Track2D-BlockPartialAdv-v0", seed=2,
                             device="cpu")
    env.reset()
    with pytest.raises(ValueError, match="render mode"):
        env.render("video")
