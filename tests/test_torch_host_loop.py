"""The port's host-env trainer (``rl/host_loop.py``) against the JAX
package's.

``make_host_update`` on one fixed ``HostBatch``, from the same params, for
four configurations (maze-lstm two-player at mode 0, maze-lstm single,
maze-lstm-continuous single, tat-maze-lstm-continuous with the aux reward
at mode -1): loss, metrics and gradients to rtol 1e-4 / atol 1e-5, the
updated params to rtol 1e-5 / atol 1e-6. Then two ``train_iter``s of both
trainers on deterministic pools, the port fed JAX's draws (re-derived from
the trainer's key as JAX splits it): the actions each pool received and
the params after each iteration agree. Then the port alone: train mode 0
leaves player1 untouched on a Track2D pool, and a single-agent toy env's
episodes of length 10 are all recorded.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_draws  # noqa: F401  (one CPU thread for torch)
from active_tracking_rl_tpu.config import NetConfig as JNetConfig
from active_tracking_rl_tpu.config import TrainConfig as JTrainConfig
from active_tracking_rl_tpu.models.dueling import build_model as jbuild
from active_tracking_rl_tpu.rl import host_loop as jhost
from active_tracking_rl_tpu.rl.learner import make_optimizer_for as j_opt_for
from active_tracking_rl_torch.config import NetConfig, TrainConfig
from active_tracking_rl_torch.envs.bridge import HostEnvPool, create_env
from active_tracking_rl_torch.models.dueling import (build_model,
                                                     params_from_flax)
from active_tracking_rl_torch.rl import host_loop
from active_tracking_rl_torch.rl.optim import make_optimizer_for
from tests.torch_draws import capture_grads

GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
PARAM_TOL = dict(rtol=1e-5, atol=1e-6)
T, B, A, HW = 4, 3, 3, (13, 13)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _draw(name):
    """JAX's sampling draw for the network's heads."""
    return jax.random.normal if "continuous" in name else jax.random.gumbel


def _batch(name, p, seed=0):
    rng = np.random.RandomState(seed)
    obs = rng.randint(0, 5, (T + 1, B, p, 1) + HW + (1,)).astype(np.float32)
    if "continuous" in name:   # raw samples, some beyond the clamp
        actions = (1.5 * rng.randn(T, B, p, A)).astype(np.float32)
    else:
        actions = rng.randint(0, A, (T, B, p)).astype(np.int32)
    rewards = rng.randn(T, B, 2).astype(np.float32)
    if p == 1:
        rewards[..., 1] = 0.0
    done = np.zeros((T, B), bool)
    done[1, 0] = done[2, 2] = True
    hx0 = (0.3 * rng.randn(B, p, 128)).astype(np.float32)
    cx0 = (0.3 * rng.randn(B, p, 128)).astype(np.float32)
    return dict(obs=obs, actions=actions, rewards=rewards, done=done,
                hx0=hx0, cx0=cx0)


@pytest.mark.parametrize("name,single,train_mode,mode,aux", [
    ("maze-lstm", False, 0, 0, "none"),
    ("maze-lstm", True, 0, 0, "none"),
    ("maze-lstm-continuous", True, -1, -1, "none"),
    ("tat-maze-lstm-continuous", False, -1, -1, "reward")])
def test_host_update_matches_jax(name, single, train_mode, mode, aux):
    p = 1 if single else 2
    jn = JNetConfig.from_name(name, aux=aux)
    jt = JTrainConfig(num_envs=B, num_steps=T, train_mode=train_mode)
    jm = jbuild(jn, A, HW, single=single)
    params = jm.init(jax.random.PRNGKey(0))
    opt = capture_grads(j_opt_for(jn, jt, params))
    data = _batch(name, p)
    key = jax.random.PRNGKey(4)
    update = jax.jit(jhost.make_host_update(jm, jn, jt, opt, not single))
    p1, (_, grads), m = update(params, opt.init(params),
                               jhost.HostBatch(**data), jnp.int32(mode), key)

    tn = NetConfig.from_name(name, aux=aux)
    tt = TrainConfig(num_envs=B, num_steps=T, train_mode=train_mode)
    model = build_model(tn, A, HW, device="cpu", single=single)
    model.load_state_dict(params_from_flax(_np(params)))
    topt = make_optimizer_for(model, tt)
    tupdate = host_loop.make_host_update(model, tn, tt, topt, not single)
    batch = host_loop.HostBatch(**{k: torch.from_numpy(v)
                                   for k, v in data.items()})
    tm = tupdate(batch, mode,
                 torch.from_numpy(np.array(_draw(name)(key, (B, A)))))

    for field in ("loss", "policy_loss", "value_loss", "entropy",
                  "pred_loss", "ep_count", "grad_norm", "ep_return",
                  "ep_len"):
        np.testing.assert_allclose(getattr(tm, field).numpy(),
                                   np.asarray(getattr(m, field)), **GRAD_TOL,
                                   err_msg=field)
    if aux == "reward":
        assert float(m.pred_loss) > 0
    want = params_from_flax(_np(grads))
    assert set(want) == set(dict(model.named_parameters()))
    for n, prm in model.named_parameters():
        g = prm.grad if prm.grad is not None else torch.zeros_like(prm)
        np.testing.assert_allclose(g.numpy(), want[n].numpy(), **GRAD_TOL,
                                   err_msg=n)
    got = model.state_dict()
    for n, w in params_from_flax(_np(p1)).items():
        np.testing.assert_allclose(got[n].numpy(), w.numpy(), **PARAM_TOL,
                                   err_msg=n)


class _RecordingPool:
    """A deterministic pool (numpy RNG from its seed; rewards depend on the
    actions; episodes of 5 steps) that records the actions it is given."""

    EP_LEN = 5

    def __init__(self, batch, players, continuous, seed=0):
        self.b, self.p, self.cont = batch, players, continuous
        self.rng = np.random.RandomState(seed)
        self.t = np.zeros(batch, np.int64)
        self.actions = []

    def __len__(self):
        return self.b

    def _obs(self):
        return self.rng.randint(0, 5, (self.b, self.p, 1, 1) + HW).astype(
            np.float32)

    def reset(self):
        return self._obs()

    def step(self, actions):
        a = np.asarray(actions)
        self.actions.append(a.copy())
        a0 = a if self.p == 1 else a[:, 0]
        r = (a0.sum(-1) / 4.0 if self.cont else (a0 == 1) * 1.0)
        self.t += 1
        done = self.t >= self.EP_LEN
        self.t[done] = 0
        rew = r[:, None] if self.p == 1 else np.stack([r, -r], -1)
        return self._obs(), rew.astype(np.float32), done, {}


def _trainer_noise(key, name):
    """The draws of one JAX train_iter from the trainer's key -> (key',
    HostNoise): one split per act, step_both's split into the tracker's and
    the target's draws, then one split for the update's bootstrap."""
    draw = _draw(name)
    acts = []
    for _ in range(T):
        key, k = jax.random.split(key)
        acts.append(np.stack([np.asarray(draw(kk, (B, A)))
                              for kk in jax.random.split(k)], axis=1))
    key, k = jax.random.split(key)
    noise = host_loop.HostNoise(torch.from_numpy(np.stack(acts)),
                                torch.from_numpy(np.array(draw(k, (B, A)))))
    return key, noise


@pytest.mark.parametrize("name,single,aux", [
    ("tat-maze-lstm", False, "reward"),
    ("maze-lstm-continuous", True, "none"),
    ("tat-maze-lstm-continuous", False, "reward")])
def test_train_iters_match_jax(name, single, aux):
    p = 1 if single else 2
    cont = "continuous" in name
    low = high = None
    if cont:
        low, high = np.full(A, -2.0, np.float32), np.full(A, 2.0, np.float32)
    jn = JNetConfig.from_name(name, aux=aux)
    jt = JTrainConfig(num_envs=B, num_steps=T, train_mode=-1)
    jpool = _RecordingPool(B, p, cont)
    jtr = jhost.HostTrainer(jbuild(jn, A, HW, single=single), jn, jt, jpool,
                            seed=0, action_low=low, action_high=high)
    params0 = _np(jtr.params)

    tn = NetConfig.from_name(name, aux=aux)
    tt = TrainConfig(num_envs=B, num_steps=T, train_mode=-1)
    pool = _RecordingPool(B, p, cont)
    tr = host_loop.HostTrainer(build_model(tn, A, HW, device="cpu",
                                           single=single),
                               tn, tt, pool, seed=0, action_low=low,
                               action_high=high)
    tr.model.load_state_dict(params_from_flax(params0))
    key = jax.random.PRNGKey(1)    # the JAX trainer's key (seed + 1)
    for it in range(2):
        m = jtr.train_iter(mode=-1)
        key, noise = _trainer_noise(key, name)
        tm = tr.train_iter(mode=-1, noise=noise)
        assert len(pool.actions) == len(jpool.actions) == T * (it + 1)
        for g, w in zip(pool.actions, jpool.actions):
            assert g.shape == w.shape
            if cont:
                np.testing.assert_allclose(g, w, **GRAD_TOL)
            else:
                np.testing.assert_array_equal(g, w)
        np.testing.assert_allclose(tm.loss.numpy(), np.asarray(m.loss),
                                   **GRAD_TOL)
        got = tr.model.state_dict()
        for n, w in params_from_flax(_np(jtr.params)).items():
            np.testing.assert_allclose(got[n].numpy(), w.numpy(),
                                       **PARAM_TOL, err_msg=f"{it} {n}")
    assert tr.finished_lens == [int(x) for x in jtr.finished_lens]
    np.testing.assert_allclose(tr.finished_returns, jtr.finished_returns,
                               **GRAD_TOL)
    if cont:
        assert max(np.abs(a).max() for a in pool.actions) <= 2.0


def _l2(a, b):
    return sum(float(((a[k] - b[k]) ** 2).sum()) for k in a)


def test_mode0_leaves_player1_untouched():
    """Train mode 0 on a Track2D host pool: the tracker moves, the target's
    parameters stay bit for bit."""
    env_id = "Track2D-EmptyPartialRam-v0"
    pool = HostEnvPool([(lambda i=i: create_env(env_id, seed=100 + i,
                                                device="cpu"))
                        for i in range(2)])
    ncfg = NetConfig.from_name("maze-lstm", aux="none")
    tcfg = TrainConfig(env_id=env_id, num_envs=2, num_steps=6, train_mode=0)
    tr = host_loop.HostTrainer(build_model(ncfg, 4, HW, device="cpu"), ncfg,
                               tcfg, pool, seed=0)
    before = {k: v.clone() for k, v in tr.model.state_dict().items()}
    for _ in range(3):
        m = tr.train_iter(mode=0)
    assert np.isfinite(float(m.loss)) and np.isfinite(float(m.grad_norm))
    after = tr.model.state_dict()
    p0 = [k for k in after if k.startswith("player0.")]
    p1 = [k for k in after if k.startswith("player1.")]
    assert _l2({k: after[k] for k in p0}, {k: before[k] for k in p0}) > 0
    for k in p1:
        assert torch.equal(after[k], before[k]), k
    assert pool.resets >= 2


class _ToyImageEnv:
    """A single-agent env: random (1, 1, 1, 13, 13) obs, reward 1 for action
    0, episodes of 10 steps."""

    def __init__(self, seed):
        self.rng = np.random.RandomState(seed)
        self.t = 0

    def _obs(self):
        return self.rng.rand(1, 1, 1, 13, 13).astype(np.float32)

    def reset(self):
        self.t = 0
        return self._obs()

    def step(self, action):
        self.t += 1
        r = np.array([1.0 if int(np.asarray(action).ravel()[0]) == 0
                      else 0.0], np.float32)
        return self._obs(), r, self.t >= 10, {}


def test_single_agent_toy_env_records_its_episodes():
    pool = HostEnvPool([(lambda i=i: _ToyImageEnv(i)) for i in range(3)])
    ncfg = NetConfig.from_name("maze-lstm", aux="none")
    tcfg = TrainConfig(num_envs=3, num_steps=6, train_mode=0)
    tr = host_loop.HostTrainer(build_model(ncfg, 4, HW, device="cpu",
                                           single=True),
                               ncfg, tcfg, pool, seed=0)
    before = {k: v.clone() for k, v in tr.model.state_dict().items()}
    for _ in range(3):
        m = tr.train_iter(mode=0)
    assert np.isfinite(float(m.loss))
    assert _l2(tr.model.state_dict(), before) > 0
    assert len(tr.finished_lens) >= 3
    assert set(tr.finished_lens) == {10}
    assert tr.hx.shape == (3, 1, 128)


@pytest.mark.parametrize("players", [1, 2])
def test_smoke_direction_pools_copy_the_jax_tests(players):
    """chip_smoke.py's numpy copy of the continuous tests' pools gives the
    same obs, rewards and done on the same actions."""
    import chip_smoke
    if players == 1:
        from tests.test_continuous import DirectionPool as Want
    else:
        from tests.test_continuous_tat import TwoPlayerDirectionPool as Want
    got = chip_smoke.DirectionPool(4, seed=5, players=players)
    want = Want(4, seed=5)
    np.testing.assert_array_equal(got.reset(), want.reset())
    rng = np.random.RandomState(0)
    for _ in range(40):
        a = rng.uniform(-2, 2, (4, players, 2) if players == 2 else (4, 2))
        g, w = got.step(a), want.step(a)
        for x, y in zip(g[:3], w[:3]):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
