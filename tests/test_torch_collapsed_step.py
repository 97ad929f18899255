"""The port's train step held to the JAX package's at a collapsed tracker.

A state of the port (``run/train.py``'s ``train_state.pt``) is carried
into the JAX package by ``tests/torch_to_jax.py``, and one learner
iteration of each package runs from it on the same draws (the Gumbel noise
that the JAX step draws from its carry key), the same pool and the same
pool pointer. After it:

- env states, positions, frame stack and done flags are equal bit for bit
  (a sampled action may differ only where logits + Gumbel are within
  rounding of the runner-up: ``NEAR_TIE``; those are counted);
- the metrics (loss, each player's entropy, grad norm, the TAT aux loss)
  agree to rtol 1e-4;
- every parameter's raw gradient (before the clip at norm 50), every
  updated parameter and SharedAdam's three moments agree within 1e-4 of
  each tensor's largest entry.

The pytest cases run at a small size (16 envs, a pool of 16 with its
pointer inside the window, the Nav tapes at ``FAST`` sizes, remat off):
the converter's round trip JAX -> port -> JAX is bit for bit, and on
each of several seeds a tracker whose policy leads one action by a bias
doubled until its entropy is below 0.01 takes one iteration in both
within the tolerances above.

Run as a script on a state that a card run saved (README.md, "The port's
collapsed states, held to JAX"), at the recipe's scale (1024 envs, a pool
of 256, 20 steps, the recipe's Nav sizes, remat on)::

    JAX_PLATFORMS=cpu python -m tests.test_torch_collapsed_step \\
        --state k16-s3-400.400.pt.xz --seed 3 --pool-refresh 16 --iters 1

The envs and the frame stack are the state's own, the pool is the
trainer's default size, and JAX's carry key is ``PRNGKey(<iteration>)``.

It prints, per iteration, both packages' ``entropies0``, the rows whose
env state differs, the near ties and the worst family errors (with
``--iters 1`` in full), and where the runs part (the first iteration
whose env state or pointer differs). ``--iters N`` goes on for N
iterations, each package on its own trajectory, on the same draws and
pools (the run's own pool windows, refreshed where run/train.py's are).
"""

from __future__ import annotations

import argparse
import copy
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from active_tracking_rl_torch.models.dueling import build_model
from active_tracking_rl_torch.config import TrainConfig
from active_tracking_rl_torch.ops import noise
from active_tracking_rl_torch.rl.optim import make_optimizer_for
from active_tracking_rl_torch.rl.rollout import init_carry, obs_to_model
from active_tracking_rl_torch.run.train import carry_state
from tests.torch_learner_pair import FAST
from tests.torch_to_jax import (MOMENTS, StepPair, jax_pool, jax_state,
                                last_tensors, load_state_file, run_pool,
                                second_look, torch_pool, torch_train_state)

ENV_ID, NETWORK = "Track2D-BlockPartialNav-v0", "tat-maze-lstm"
B, P, T = 16, 16, 20
METRIC_RTOL = 1e-4
#: metric values below float32's smallest normal count as 0: XLA's CPU
#: code flushes subnormals to zero (an entropy mean of 3.5e-44), torch not
METRIC_FLOOR = float(np.finfo(np.float32).tiny)
#: the worst |port - JAX| of a tensor over its largest entry
SCALE_TOL = 1e-4
LOW_ENTROPY = 0.01
HELD = ("grads", "params") + MOMENTS


def sharpen_tracker(model, obs_stack, limit=LOW_ENTROPY):
    """Set the tracker's policy bias to `lead` on one action (the one the
    head's mean logits favour) and 0 elsewhere, the lead doubled from 1
    until the mean entropy at the first step on `obs_stack`, from a zero
    recurrent state, is below `limit` -> (lead, entropy).

    chip_smoke.py's sharpen_tracker scales the whole head by powers of 2
    instead (2^12 to 2^16 on a fresh head here). At this size that leaves
    some seeds at float32's floor: seeds 5 and 6 part by 1.1-1.4e-4 of
    scale in the encoder's gradients and second moments, and on seed 5
    each package's float32 run is 6.8e-5 from its own float64 run, the
    two float64 runs agreeing. The lead collapses the policy and leaves
    the head's weights as they are."""
    head = model.player0.policy
    obs = obs_to_model(obs_stack)[:, 0]
    h = torch.zeros((obs.shape[0], model.cfg.rnn_out))
    lead = 1.0
    with torch.no_grad():
        action = int(model.tracker_fwd(obs, h, h).logits.mean(0).argmax())
        while True:
            head.bias.zero_()
            head.bias[action] = lead
            log_p = torch.log_softmax(model.tracker_fwd(obs, h, h).logits, -1)
            entropy = float(-(log_p.exp() * log_p).sum(-1).mean())
            if entropy < limit:
                return lead, entropy
            assert lead <= 2 ** 10, entropy
            lead *= 2


def snapshot(pair: StepPair, carry, ptr: int, step: int) -> dict:
    """The port's state as run/train.py saves it (copies)."""
    return copy.deepcopy({
        "model": pair.model.state_dict(), "optimizer": pair.opt.state_dict(),
        "carry": carry_state(carry), "pool_ptr": torch.tensor([ptr]),
        "step": step})


def sharpened_state(pair: StepPair, seed: int = 1, steps: int = 2):
    """A port state from `seed` whose tracker is sharpened below
    LOW_ENTROPY, after `steps` of the port's own train steps on one pool
    (so that the moments, hx and cx are not zero and the pointer is inside
    the window) -> (state, pool, pointer, lead)."""
    gen = noise.generator(seed, "cpu")
    pair.model.reset_parameters(gen)
    pair.opt.state.clear()
    pair.opt.param_groups[0]["step"] = 0
    carry = init_carry(pair.env, pair.ncfg, B, gen)
    lead, _ = sharpen_tracker(pair.model, carry.obs_stack)
    pool = pair.env.reset_batch(P, gen)
    ptr = torch.tensor(0)
    for _ in range(steps):
        carry, _, ptr = pair.tstep(carry, 0, (*pool, ptr))
    return snapshot(pair, carry, int(ptr), steps), pool, int(ptr), lead


@pytest.fixture(scope="module")
def pair():
    return StepPair(ENV_ID, NETWORK, 1, 0, B, P, T, remat=False, sizes=FAST)


def _leaves_equal(a, b) -> None:
    la, ta = jax.tree_util.tree_flatten(a)
    lb, tb = jax.tree_util.tree_flatten(b)
    assert ta == tb
    for x, y in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def test_round_trip_jax_port_jax_is_bit_for_bit(pair):
    saved, pool, ptr, _ = sharpened_state(pair, seed=2)
    key = jax.random.PRNGKey(5)
    params, opt_state, carry = pair.load(saved, key)
    jpool = jax_pool(*pool, ptr)
    # one JAX step, so that every moment and the carry are JAX's own
    params, opt_state, carry, _, jptr = pair.jstep(
        params, opt_state, carry, jnp.int32(0), jpool)
    jpool = (*jpool[:2], jptr)
    model = build_model(pair.ncfg, pair.ecfg.num_actions, pair.ecfg.obs_shape,
                        device="cpu")
    opt = make_optimizer_for(model, pair.tcfg)
    state = torch_train_state(params, opt_state, carry, model, opt, 0,
                              saved["carry"]["generator"], jptr)
    back = jax_state(state, model, pair.ncfg, 0, pair.jopt, carry.key)
    _leaves_equal((params, opt_state[0], carry), (back[0], back[1][0],
                                                  back[2]))
    tpool = torch_pool(jpool)
    _leaves_equal(jpool, jax_pool(*tpool))
    assert int(state["pool_ptr"][0]) == int(jptr) == tpool[2]


def test_run_pool_rebuilds_the_pool_a_refresh_1_step_draws(pair):
    """At --pool-refresh 1 the step draws its pool from the carry's
    generator after its noise; run_pool rebuilds that pool (pointer 0), so
    the check can hand it to both packages."""
    saved, *_ = sharpened_state(pair, seed=3)
    pool, ptr = run_pool(pair.env, saved, 3, 1, B, P, T)
    assert ptr == 0
    ends = []
    for given in (None, (*pool, torch.tensor(0))):
        pair.load(saved, jax.random.PRNGKey(0))
        carry, m, _ = pair.tstep(pair.tcarry, 0, given)
        ends.append((carry, float(m.loss)))
    (c0, l0), (c1, l1) = ends
    assert l0 == l1
    for f in ("pos", "maze", "tape", "t", "done"):
        assert torch.equal(getattr(c0.env_state, f), getattr(c1.env_state, f))
    assert torch.equal(c0.hx, c1.hx)


def check(result) -> list:
    """The tolerances the result breaks, as messages (none: it holds)."""
    bad = []
    if result.state_rows_differ:
        bad.append(f"env state differs in {result.state_rows_differ} rows")
    m, tm = result.jax_metrics, result.port_metrics
    for name in ("loss", "entropy", "grad_norm", "pred_loss"):
        w = np.asarray(getattr(m, name), np.float64)
        g = getattr(tm, name).double().numpy()
        if not np.all(np.abs(g - w) <= METRIC_RTOL * np.abs(w)
                      + METRIC_FLOOR):
            bad.append(f"metric {name}: port {g} JAX {w}")
    for what in HELD:
        for family, err in result.worst[what].items():
            if err > SCALE_TOL:
                bad.append(f"{what} {family}: {err:.3e} of scale")
    return bad


@pytest.mark.parametrize("seed", range(1, 7))
def test_sharpened_tracker_step_holds_to_jax(pair, seed):
    saved, pool, ptr, lead = sharpened_state(pair, seed=seed)
    params, opt_state, carry = pair.load(saved, jax.random.PRNGKey(9))
    result, *_ = pair.step(params, opt_state, carry, pool, ptr, ptr)
    assert lead >= 2
    assert float(result.port_metrics.entropy[0]) < LOW_ENTROPY
    assert float(result.port_metrics.grad_norm) > 0
    assert check(result) == []


def report(result, full: bool) -> str:
    m, tm = result.jax_metrics, result.port_metrics
    line = (f"iter {result.it} entropies0 JAX {float(m.entropy[0]):.6g} port "
            f"{float(tm.entropy[0]):.6g} rows_differ "
            f"{result.state_rows_differ} near_ties {result.near_ties}")
    if not full:
        return line
    out = [line]
    for name in ("loss", "entropy", "grad_norm", "pred_loss", "policy_loss",
                 "value_loss"):
        w = np.asarray(getattr(m, name), np.float64)
        g = getattr(tm, name).double().numpy()
        rel = np.abs(g - w) / np.maximum(np.abs(w), 1e-30)
        out.append(f"  metric {name}: JAX {np.round(w, 8).tolist()} port "
                   f"{np.round(g, 8).tolist()} rel {rel.max():.2e}")
    for what, fam in result.worst.items():
        worst = max(fam.items(), key=lambda kv: kv[1])
        out.append(f"  worst {what}: {worst[1]:.3e} ({worst[0]}); "
                   + json.dumps({k: float(f"{v:.3e}") for k, v in
                                 sorted(fam.items())}))
    bad = check(result)
    out.append("  HOLDS" if not bad else "  PARTS: " + "; ".join(bad))
    return "\n".join(out)


def print_second_look(look) -> None:
    """Per quantity, the worst family of each comparison, then each family
    where the float32 programs part by more than SCALE_TOL."""
    for what, fams in look.items():
        labels = next(iter(fams.values())).keys()
        worst = {lab: max(f[lab] for f in fams.values()) for lab in labels}
        print(f"second look {what}: " + ", ".join(
            f"{lab} {v:.3e}" for lab, v in worst.items()))
        for fam, errs in sorted(fams.items()):
            if errs["port32-jax32"] > SCALE_TOL:
                print(f"  {what} {fam}: " + ", ".join(
                    f"{lab} {v:.3e}" for lab, v in errs.items()))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--state", required=True,
                    help="a train_state.pt (or its .xz) saved by run/train.py")
    ap.add_argument("--seed", type=int, required=True,
                    help="the run's --seed (its pool generator's)")
    ap.add_argument("--pool-refresh", type=int, default=1)
    ap.add_argument("--iters", type=int, default=1)
    ap.add_argument("--x64", action="store_true",
                    help="both packages in float64 (the second look)")
    ap.add_argument("--dump", help="write the first iteration's tensors of "
                                   "both packages here (.npz)")
    ap.add_argument("--against", nargs="+", default=(),
                    help="float32 runs' --dump of the same state: print the "
                         "second look against each (--x64)")
    ap.add_argument("--native-conv", action="store_true",
                    help="the port's CPU convolutions by torch's own kernels, "
                         "not oneDNN's (whose float32 sums are the less "
                         "accurate on this path)")
    args = ap.parse_args(argv)
    if args.native_conv:
        torch.backends.mkldnn.enabled = False
    if args.x64:
        jax.config.update("jax_enable_x64", True)
    if args.iters > 1 and args.pool_refresh == 1:
        ap.error("--iters > 1 follows the pool windows of --pool-refresh > 1")
    torch.set_num_threads(1)
    t0 = time.time()
    saved = load_state_file(args.state)
    step0 = int(saved["step"])
    num_envs, _, stack = saved["carry"]["obs_stack"].shape[:3]
    reset_pool = TrainConfig().reset_pool
    pair = StepPair(ENV_ID, NETWORK, stack, 0, num_envs, reset_pool, T,
                    remat=True, x64=args.x64)
    params, opt_state, carry = pair.load(saved, jax.random.PRNGKey(step0))
    print(f"state {args.state}: iteration {step0}, pool pointer "
          f"{saved['pool_ptr']}", flush=True)
    parted = None
    pool = jptr = tptr = None
    refresh = args.pool_refresh
    for i in range(1, args.iters + 1):
        it = step0 + i
        t1 = time.time()
        if i == 1:
            pool, jptr = run_pool(pair.env, saved, args.seed, refresh,
                                  num_envs, reset_pool, T)
            tptr = jptr
        elif (it - 1) % refresh == 0:
            pool, jptr = run_pool(pair.env, dict(saved, step=it - 1),
                                  args.seed, refresh, num_envs, reset_pool,
                                  T)
            tptr = jptr
        t_pool = time.time() - t1
        result, params, opt_state, carry, jptr, tptr = pair.step(
            params, opt_state, carry, pool, jptr, tptr, it=it)
        if parted is None and (result.state_rows_differ or jptr != tptr):
            parted = it
        print(report(result, args.iters == 1) + f" pool_s {t_pool:.1f} "
              f"step_s {time.time() - t1 - t_pool:.1f}", flush=True)
        if i == 1 and args.dump:
            np.savez(args.dump, **last_tensors(pair))
        for path in args.against if i == 1 else ():
            print(f"against {path}")
            print_second_look(second_look(dict(np.load(path)),
                                          last_tensors(pair)))
    print(f"parted at iteration {parted}" if parted else
          f"in lockstep for all {args.iters} iterations", flush=True)
    print(f"seconds {time.time() - t0:.1f}")


if __name__ == "__main__":
    main()
