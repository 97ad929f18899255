"""Many train steps of the port in lockstep with the JAX package on the
amortized reset pool (``--pool-refresh 16``), in the config of RESULTS.md
§1.9's stack-4 and K=16 Nav recipes (tat-maze-lstm on
Track2D-BlockPartialNav-v0, train mode 0). One set of initial params;
every step's sampling noise re-derived from JAX's carry key. The pool
windows refresh at the iterations run/train.py's do (``(it - 1) % 16 ==
0``) and restart the pointer there, which then wraps inside the window;
but each window's draws come from ``fold_in(PRNGKey(2), it)`` through
tests/torch_draws.py:batch_draws, for both packages, not from
run/train.py's ``iteration_generator(seed + POOL_SEED, window)``.

The pytest case runs 16 envs on a pool of 16 rows, with the Nav tapes at
the learner tests' reduced FAST sizes (tests/torch_learner_pair.py: 4 goal
candidates, 96 flood iterations, tapes of 96 ticks; the recipe's are 16,
256 and 512) and remat off. Over 48 iterations (three pool windows, 16
envs x 20 steps each) every env state equals JAX's bit for bit after
every iteration; the tracker's entropy and the loss agree to rtol 1e-4 /
atol 1e-5 each iteration, and the parameters at the end to atol 1e-5
(float32 on both sides; measured 6.0e-8 at one frame, 1.2e-7 at four).

Run as a script for the recipe's scale: 1024 envs on a pool of 256 rows
(so one pool row serves several envs within a step and within a window),
the recipe's Nav sizes (the env config's own) and remat on in both, as
the trainer CLIs train, for up to 600 iterations, printing where the two
trajectories part (the first iteration whose positions differ, once float
rounding has flipped a sampled action)::

    JAX_PLATFORMS=cpu python -m tests.test_torch_lockstep_k16 --stack 4
"""

from __future__ import annotations

import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from active_tracking_rl_tpu.config import parse_env_id
from active_tracking_rl_tpu.rl.rollout import TrainCarry as JCarry
from active_tracking_rl_torch.models.dueling import params_from_flax
from active_tracking_rl_torch.ops.noise import Threefry
from active_tracking_rl_torch.rl.learner import init_pool_ptr
from active_tracking_rl_torch.rl.rollout import TrainCarry
from tests.torch_draws import assert_state_equal, batch_draws, step_noise
from tests.torch_learner_pair import FAST, _host, build_pair

ENV_ID = "Track2D-BlockPartialNav-v0"
REFRESH, T = 16, 20
TOL = dict(rtol=1e-4, atol=1e-5)
#: the script's horizon: the recipe's 1024 envs and pool of 256, remat on,
#: 600 iterations
SCRIPT_ENVS, SCRIPT_POOL, SCRIPT_REMAT, SCRIPT_ITERS = 1024, 256, True, 600


def lockstep(num_envs: int, pool_rows: int, iters: int, stack: int,
             sizes: dict, remat: bool = False):
    """Yield (iteration, JAX metrics, port metrics, JAX carry, port carry,
    JAX params, port model, JAX pool pointer, port pool pointer) after each
    of `iters` iterations of `num_envs` envs on a pool of `pool_rows`
    rows; `sizes` replaces fields of the env's config, and `remat` is
    both packages' ``TrainConfig.remat``."""
    b, p = num_envs, pool_rows
    ecfg = dataclasses.replace(parse_env_id(ENV_ID), **sizes)
    jenv, params, opt, step, env, model, ts, *_ = build_pair(
        ecfg, ENV_ID, "tat-maze-lstm", 0, stack, b, T, reset_pool=p,
        remat=remat)
    reset = jax.jit(lambda k: jenv.reset_batch(k, b))
    reset_pool = jax.jit(lambda k: jenv.reset_batch(k, p))
    state, obs = reset(jax.random.PRNGKey(1))
    hx = jnp.zeros((b, 2, 128), jnp.float32)
    carry = JCarry(state, jnp.repeat(obs[:, :, None], stack, axis=2), hx, hx,
                   jax.random.PRNGKey(3))
    tstate, tobs = env.reset(batch_draws(ecfg, jax.random.PRNGKey(1), b))
    tcarry = TrainCarry(tstate, tobs[:, :, None].repeat(1, 1, stack, 1, 1),
                        torch.zeros(b, 2, 128), torch.zeros(b, 2, 128),
                        Threefry().manual_seed(0))
    opt_state = opt.init(params)
    for it in range(1, iters + 1):
        if (it - 1) % REFRESH == 0:     # run/train.py's window, pointer 0
            key = jax.random.fold_in(jax.random.PRNGKey(2), it)
            pool, ptr = reset_pool(key), jnp.int32(0)
            tpool, tptr = env.reset(batch_draws(ecfg, key, p)), init_pool_ptr(
                device="cpu")
        noise = step_noise(carry.key, T, b, ecfg.num_actions)
        params, opt_state, carry, m, ptr = step(
            params, opt_state, carry, jnp.int32(0), (*pool, ptr))
        tcarry, tm, tptr = ts(tcarry, 0, (*tpool, tptr), noise)
        yield it, m, tm, carry, tcarry, params, model, ptr, tptr


@pytest.mark.parametrize("stack", [1, 4])
def test_k16_pool_steps_in_lockstep_with_jax(stack):
    wraps = 0
    for it, m, tm, carry, tcarry, params, model, ptr, tptr in lockstep(
            16, 16, 48, stack, FAST):
        assert int(tptr) == int(ptr), it
        assert_state_equal(tcarry.env_state, carry.env_state)
        np.testing.assert_array_equal(tcarry.obs_stack.numpy(),
                                      np.asarray(carry.obs_stack))
        for name in ("loss", "entropy"):
            np.testing.assert_allclose(getattr(tm, name).numpy(),
                                       np.asarray(getattr(m, name)), **TOL,
                                       err_msg=f"{name} at {it}")
        wraps += float(tm.ep_count) > 0
    assert wraps > 10                    # episodes ended and reset from the pool
    got = model.state_dict()
    for name, w in params_from_flax(_host(params)).items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=0,
                                   atol=1e-5, err_msg=name)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stack", type=int, default=1)
    args = ap.parse_args(argv)
    for it, m, tm, carry, tcarry, params, model, ptr, tptr in lockstep(
            SCRIPT_ENVS, SCRIPT_POOL, SCRIPT_ITERS, args.stack, {},
            SCRIPT_REMAT):
        same = int(tptr) == int(ptr) and np.array_equal(
            tcarry.env_state.pos.numpy(), np.asarray(carry.env_state.pos))
        if it % 10 == 0 or it == SCRIPT_ITERS or not same:
            want = params_from_flax(_host(params))
            got = model.state_dict()
            diff = max(float((got[k] - w).abs().max()) for k, w in want.items())
            print(f"iter {it} entropy0 JAX {float(m.entropy[0]):.4f} port "
                  f"{float(tm.entropy[0]):.4f} ep_len {float(m.ep_len):.1f} "
                  f"{float(tm.ep_len):.1f} max |param diff| {diff:.2e}",
                  flush=True)
        if not same:
            print(f"parted at iteration {it}")
            return
    print(f"in lockstep for all {SCRIPT_ITERS} iterations")


if __name__ == "__main__":
    main()
