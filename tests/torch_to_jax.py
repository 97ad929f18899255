"""A port train state carried into the JAX package, and one learner
iteration of both packages from it.

``run/train.py`` saves the port's exact-resume state, ``train_state.pt``:
the model's state_dict, SharedAdam's state_dict, the carry
(``carry_state``: env state, frame stack, ``hx``, ``cx``, generator) and
the pool pointer. ``jax_state`` turns it into the JAX package's params
tree, optax state (``rl/optim.py:SharedAdamState`` under the train mode's
mask), ``TrainCarry`` (with a JAX key chosen by the caller) and pool;
``torch_train_state`` is its inverse, so a JAX state goes to the port and
back bit for bit. ``run_pool`` rebuilds the reset pool that the run's
next iteration reads, from the run's own generators.

``StepPair`` holds both packages' train steps at one configuration
(external pool; JAX's optimizer also hands back the raw gradients) and
``StepPair.step`` runs one iteration of each from one state, on the
Gumbel noise that the JAX step draws from its carry key (re-derived by
``tests/torch_draws.py:step_noise`` for the port), and compares what
they give: env state and frame stack bit for bit, the metrics, and per
tensor the raw gradients, the updated parameters, the updates and the
three Adam moments, as a share of each tensor's largest entry.

``StepPair(..., x64=True)`` is the same iteration in float64 in both
packages, for a second look at a tensor that parts: the process must have
``jax_enable_x64`` on. The model, its inputs, the recurrent state, the
noise and the optimizer's state are float64; the encoders' cast of their
features to float32 and the port's float32 grad norm are lifted; the JAX
env, which under x64 computes in 64-bit types, has its outputs cast back
to the float32 program's dtypes (the env's own integer and float32 state
stays what it is in both packages), and both sample with the float32
program's Gumbel noise, so that both runs take the same actions.
``last_tensors`` gives the tensors an iteration produced, so that a
float32 run and a float64 run of one state (two processes) can be
compared (``second_look``).
"""

from __future__ import annotations

import dataclasses
import io
import lzma
from typing import Dict, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
import torch

from active_tracking_rl_tpu.config import parse_env_id
from active_tracking_rl_tpu.envs.types import EnvState as JaxEnvState
from active_tracking_rl_tpu.rl.optim import SharedAdamState
from active_tracking_rl_tpu.rl.rollout import TrainCarry as JCarry
from active_tracking_rl_torch.envs.env import TrackEnv
from active_tracking_rl_torch.envs.types import EnvState
from active_tracking_rl_torch.models.dueling import (params_from_flax,
                                                     params_to_flax)
from active_tracking_rl_torch.ops import noise as noise_mod
from active_tracking_rl_torch.rl.learner import draw_step_noise
from active_tracking_rl_torch.rl.optim import trained_parameters
from active_tracking_rl_torch.rl.rollout import TrainCarry, run_rollout
from active_tracking_rl_torch.run.train import (POOL_SEED,
                                                iteration_generator,
                                                restore_carry)
from tests.torch_draws import step_noise
from tests.torch_learner_pair import build_pair

MOMENTS = ("exp_avg", "exp_avg_sq", "max_exp_avg_sq")
#: a sampled action is a near tie where the winning logits + Gumbel is
#: within this share of its magnitude (at least 1) of the runner-up: float32
#: rounding of the logits can give either package the other action
NEAR_TIE = 1e-5


def load_state_file(path: str) -> Dict:
    """The dict inside a train_state.pt, or its lzma-packed copy (.xz)."""
    with open(path, "rb") as f:
        raw = f.read()
    if path.endswith(".xz"):
        raw = lzma.decompress(raw)
    payload = torch.load(io.BytesIO(raw), map_location="cpu",
                         weights_only=True)
    return payload["state"]


def _trained_names(model, train_mode: int):
    """The state_dict names of the parameters the optimizer holds, in its
    order (rl/optim.py:trained_parameters)."""
    ids = {id(p): n for n, p in model.named_parameters()}
    return [ids[id(p)] for p in trained_parameters(model, train_mode)]


def _jax(x) -> jnp.ndarray:
    """A JAX copy of a numpy array or a CPU tensor. Not jnp.asarray: on the
    CPU that may share the buffer of a tensor which the port then updates
    in place while JAX's asynchronous step still reads it (a bias's numpy
    view is contiguous, so params_to_flax does not copy it)."""
    return jnp.array(x.numpy() if torch.is_tensor(x) else x, copy=True)


def _tree(named: Dict[str, torch.Tensor], ncfg) -> Dict:
    return jax.tree_util.tree_map(_jax, params_to_flax(named, ncfg))


def _is_adam(x) -> bool:
    return isinstance(x, SharedAdamState)


def jax_opt_state(opt_sd: Dict, model, ncfg, train_mode: int, jopt, params):
    """SharedAdam's state_dict as the JAX optimizer's state: its step count
    and the three moments of the trained players; a masked player keeps
    JAX's placeholder."""
    names = _trained_names(model, train_mode)
    state = opt_sd["state"]          # empty before the first step: zeros
    sd = model.state_dict()
    moments = {m: _tree({n: state[i][m] if i in state else
                         torch.zeros_like(sd[n])
                         for i, n in enumerate(names)}, ncfg)
               for m in MOMENTS}
    step = jnp.asarray(opt_sd["param_groups"][0]["step"], jnp.int32)

    def fill(x):
        if not _is_adam(x):
            return x
        return SharedAdamState(step, *(
            {k: moments[m].get(k, v) for k, v in getattr(x, m).items()}
            for m in MOMENTS))

    return jax.tree_util.tree_map(fill, jopt.init(params), is_leaf=_is_adam)


def jax_env_state(state) -> JaxEnvState:
    """A port EnvState, or carry_state's dict of its fields, for JAX."""
    fields = state if isinstance(state, dict) else dataclasses.asdict(state)
    return JaxEnvState(**{k: _jax(v) for k, v in fields.items()})


def jax_carry(saved: Dict, key) -> JCarry:
    """carry_state's dict as JAX's TrainCarry, its key `key`."""
    return JCarry(jax_env_state(saved["env_state"]), _jax(saved["obs_stack"]),
                  _jax(saved["hx"]), _jax(saved["cx"]), key)


def jax_pool(pool_state: EnvState, pool_obs: torch.Tensor, ptr) -> tuple:
    return (jax_env_state(pool_state), _jax(pool_obs), jnp.int32(int(ptr)))


def jax_state(saved: Dict, model, ncfg, train_mode: int, jopt, key):
    """A port train state -> (JAX params, optimizer state, carry)."""
    params = _tree(saved["model"], ncfg)
    return (params, jax_opt_state(saved["optimizer"], model, ncfg,
                                  train_mode, jopt, params),
            jax_carry(saved["carry"], key))


def _np_to_torch(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def torch_train_state(params, opt_state, carry: JCarry, model, opt,
                      train_mode: int, generator_state, pool_ptr=None) -> Dict:
    """The inverse of ``jax_state``: the JAX state loaded into `model` and
    `opt` (the port's), and returned as run/train.py's train_state dict."""
    model.load_state_dict(params_from_flax(jax.tree_util.tree_map(
        np.asarray, params)))
    adam = next(x for x in jax.tree_util.tree_leaves(opt_state,
                                                     is_leaf=_is_adam)
                if _is_adam(x))
    moments = {m: params_from_flax(jax.tree_util.tree_map(
        np.asarray, {k: v for k, v in getattr(adam, m).items()
                     if isinstance(v, dict)})) for m in MOMENTS}
    sd = opt.state_dict()
    names = _trained_names(model, train_mode)
    sd["state"] = {i: {m: moments[m][n] for m in MOMENTS}
                   for i, n in enumerate(names)}
    sd["param_groups"][0]["step"] = int(adam.step)
    opt.load_state_dict(sd)
    return {"model": model.state_dict(), "optimizer": opt.state_dict(),
            "carry": {"env_state": {f: _np_to_torch(getattr(
                carry.env_state, f)) for f in EnvState.__dataclass_fields__},
                "obs_stack": _np_to_torch(carry.obs_stack),
                "hx": _np_to_torch(carry.hx), "cx": _np_to_torch(carry.cx),
                "generator": generator_state},
            "pool_ptr": None if pool_ptr is None else torch.tensor(
                [int(pool_ptr)]),
            "step": int(adam.step)}


def torch_pool(jpool) -> tuple:
    """JAX's (EnvState[P], obs, pointer) as the port's."""
    state, obs, ptr = jpool
    return (EnvState(**{f: _np_to_torch(getattr(state, f))
                        for f in EnvState.__dataclass_fields__}),
            _np_to_torch(obs), int(ptr))


def run_pool(env: TrackEnv, saved: Dict, seed: int, refresh: int,
             num_envs: int, reset_pool: int, num_steps: int):
    """The pool (state, obs) and pointer that run/train.py's next iteration
    after `saved` reads: with `refresh` K > 1, the window's pool from the
    run's pool generator (pointer 0 at a window's first iteration, else the
    saved one); with K = 1, the pool the step draws from the carry's
    generator after the step's noise (pointer 0)."""
    it = int(saved["step"]) + 1
    if refresh > 1:
        window = it - (it - 1) % refresh
        pool = env.reset_batch(reset_pool, iteration_generator(
            seed + POOL_SEED, window, "cpu"))
        ptr = 0 if (it - 1) % refresh == 0 else int(saved["pool_ptr"][0])
        return pool, ptr
    gen = noise_mod.generator(0, "cpu")
    gen.set_state(saved["carry"]["generator"].cpu())
    draw_step_noise(num_steps, num_envs, env.num_actions, gen, "cpu")
    return env.reset_batch(reset_pool, gen), 0


def worst_by_family(got: Dict[str, torch.Tensor],
                    want: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Per family (a layer: a tensor's name less its last part), the
    largest max|got - want| / max|want| over its tensors (the difference
    itself where want is all zeros)."""
    out: Dict[str, float] = {}
    for name, w in want.items():
        family = name.rsplit(".", 1)[0]
        w = w.double()
        diff = float((got[name].double() - w).abs().max())
        scale = float(w.abs().max())
        out[family] = max(out.get(family, 0.0),
                          diff / scale if scale > 0 else diff)
    return out


class StepResult(NamedTuple):
    """What one iteration of both packages from one state gave."""

    it: int
    jax_metrics: object
    port_metrics: object
    #: rows whose env state, or frame stack, differ after the iteration
    state_rows_differ: int
    #: sampled actions within NEAR_TIE of the runner-up (the port's logits)
    near_ties: int
    #: per quantity ("grads", "params", "updates", *MOMENTS): worst family
    worst: Dict[str, Dict[str, float]]


class _View:
    """A module's view of a library with some attributes replaced: a patch
    that reaches only the module whose global it becomes."""

    def __init__(self, lib, **replaced):
        self._lib = lib
        self.__dict__.update(replaced)

    def __getattr__(self, name):
        return getattr(self._lib, name)


def _categorical32(key, logits, axis=-1):
    """jax.random.categorical with the float32 program's Gumbel noise."""
    return jnp.argmax(jax.random.gumbel(key, logits.shape, jnp.float32)
                      .astype(logits.dtype) + logits, axis=axis)


def _same_dtypes(out, like):
    """`out` with each array cast to the dtype of its counterpart in `like`."""
    return jax.tree_util.tree_map(lambda o, l: o.astype(l.dtype), out, like)


def _lift_float32(jenv) -> None:
    """Patch both packages for a float64 iteration (a process of its own:
    this stays for the process)."""
    from active_tracking_rl_tpu.models import encoders as jenc
    from active_tracking_rl_tpu.models import heads as jheads
    from active_tracking_rl_torch.models import encoders as tenc
    from active_tracking_rl_torch.rl import learner as tlearner
    from active_tracking_rl_torch.rl import optim as toptim
    from active_tracking_rl_torch.rl import rollout as trollout
    assert jax.config.jax_enable_x64, "a float64 pair needs jax_enable_x64"
    jenc.jnp = _View(jnp, float32=jnp.float64)
    jheads.jax = _View(jax, random=_View(jax.random,
                                         categorical=_categorical32))
    tenc.torch = _View(torch, float32=torch.float64)

    def obs_to_model(obs_stack):
        return obs_stack.to(torch.float64)[..., None]

    def global_norm(tensors):
        return torch.sqrt(sum((t.double() ** 2).sum() for t in tensors))

    trollout.obs_to_model = tlearner.obs_to_model = obs_to_model
    toptim.global_norm = tlearner.global_norm = global_norm
    step_batch, autoreset = jenv.step_batch, jenv.autoreset

    def step_batch64(state, actions):
        new, obs, rewards, done, info = step_batch(state, actions)
        return (_same_dtypes(new, state), obs.astype(jnp.uint8),
                rewards.astype(jnp.float32), done, info)

    def autoreset64(state, obs, done, pool_state, pool_obs, ptr):
        return _same_dtypes(autoreset(state, obs, done, pool_state, pool_obs,
                                      ptr), (state, obs, ptr))

    jenv.step_batch, jenv.autoreset = step_batch64, autoreset64


def _wide(x):
    if jnp.issubdtype(x.dtype, jnp.floating):
        return x.astype(jnp.float64)
    return x


class StepPair:
    """Both packages' train steps of one recipe on the CPU, float32 (or
    float64 with `x64`)."""

    def __init__(self, env_id: str, network: str, stack: int, train_mode: int,
                 num_envs: int, reset_pool: int, num_steps: int = 20,
                 remat: bool = True, sizes: Optional[Dict] = None,
                 x64: bool = False):
        self.ecfg = dataclasses.replace(parse_env_id(env_id), **(sizes or {}))
        self.train_mode, self.num_steps, self.num_envs = (train_mode,
                                                          num_steps, num_envs)
        self.x64 = x64

        def lift(jenv, model):
            _lift_float32(jenv)
            model.double()

        pair = build_pair(self.ecfg, env_id, network, train_mode, stack,
                          num_envs, num_steps, grads=True,
                          reset_pool=reset_pool, remat=remat,
                          lift=lift if x64 else None)
        self.jopt, self.jstep = pair.opt, pair.step
        self.env, self.model, self.tstep = pair.env, pair.model, pair.tstep
        self.opt, self.tcfg, self.ncfg = pair.topt, pair.tcfg, pair.model.cfg
        self._grads: Dict[str, torch.Tensor] = {}
        step = self.opt.step

        def keep_grads_then_step():
            self._grads = {n: (p.grad.clone() if p.grad is not None
                               else torch.zeros_like(p))
                           for n, p in self.model.named_parameters()}
            step()

        self.opt.step = keep_grads_then_step

    def load(self, saved: Dict, key):
        """Both packages at `saved` (a train_state dict); JAX's carry key
        is `key`. Returns JAX's (params, optimizer state, carry)."""
        self.model.load_state_dict(saved["model"])
        self.opt.load_state_dict(saved["optimizer"])  # to the params' dtype
        self.tcarry = restore_carry(saved["carry"],
                                    noise_mod.generator(0, "cpu"))
        out = jax_state(saved, self.model, self.ncfg, self.train_mode,
                        self.jopt, key)
        if self.x64:
            self.tcarry.hx = self.tcarry.hx.double()
            self.tcarry.cx = self.tcarry.cx.double()
            params, opt_state = jax.tree_util.tree_map(_wide, out[:2])
            out = (params, opt_state, out[2]._replace(hx=_wide(out[2].hx),
                                                      cx=_wide(out[2].cx)))
        return out

    def near_ties(self, carry: TrainCarry, pool, ptr: int, noise) -> int:
        """Replay the port's rollout without gradients from `carry` and count
        the sampled actions within NEAR_TIE of the runner-up."""
        count = [0]
        sample = self.model.sample

        def counting(out, gumbel, test=False):
            if gumbel is not None and not test:
                v = (out.logits.detach() + gumbel).double()
                top = torch.topk(v, 2, dim=-1).values
                gap = top[:, 0] - top[:, 1]
                count[0] += int((gap <= NEAR_TIE * top[:, 0].abs().clamp_min(
                    1.0)).sum())
            return sample(out, gumbel, test)

        self.model.sample = counting
        try:
            with torch.no_grad():
                tcfg = dataclasses.replace(self.tcfg, remat=False)
                run_rollout(self.model, self.env, tcfg, TrainCarry(
                    carry.env_state.map(torch.clone), carry.obs_stack.clone(),
                    carry.hx.clone(), carry.cx.clone(), carry.generator),
                    pool, torch.tensor(ptr), noise.actions)
        finally:
            del self.model.sample
        return count[0]

    def step(self, params, opt_state, carry: JCarry, pool, jptr: int,
             tptr: int, mode: int = 0, it: int = 0):
        """One iteration of both: JAX from (params, opt_state, carry), the
        port from its model, optimizer and self.tcarry, on the port's pool
        (state, obs), JAX from pointer `jptr` and the port from `tptr`.
        Returns (StepResult, JAX's params', opt_state', carry', jptr',
        the port's tptr')."""
        noise = step_noise(carry.key, self.num_steps, self.num_envs,
                           self.ecfg.num_actions)
        if self.x64:
            noise = type(noise)(*(x.double() for x in noise))
        ties = self.near_ties(self.tcarry, pool, tptr, noise)
        before = {k: v.clone() for k, v in self.model.state_dict().items()}
        jbefore = params
        params, opt_state, carry, m, jptr = jax.block_until_ready(self.jstep(
            params, opt_state, carry, jnp.int32(mode), jax_pool(*pool, jptr)))
        self.tcarry, tm, tptr = self.tstep(
            self.tcarry, mode, (*pool, torch.tensor(tptr)), noise)
        rows = np.zeros(self.num_envs, bool)
        for f in EnvState.__dataclass_fields__:
            g = getattr(self.tcarry.env_state, f).numpy()
            w = np.asarray(getattr(carry.env_state, f))
            rows |= (g != w).reshape(len(rows), -1).any(-1)
        rows |= (self.tcarry.obs_stack.numpy() != np.asarray(
            carry.obs_stack)).reshape(len(rows), -1).any(-1)
        jhost = jax.tree_util.tree_map(np.asarray, params)
        want_params = params_from_flax(jhost)
        want_before = params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                              jbefore))
        got = {k: v.clone() for k, v in self.model.state_dict().items()}
        inner, grads = opt_state
        adam = next(x for x in jax.tree_util.tree_leaves(inner,
                                                         is_leaf=_is_adam)
                    if _is_adam(x))
        names = _trained_names(self.model, self.train_mode)
        ost = self.opt.state_dict()["state"]
        port = {"grads": self._grads, "params": got}
        jax_side = {"grads": params_from_flax(jax.tree_util.tree_map(
            np.asarray, grads)), "params": want_params}
        for mom in MOMENTS:
            port[mom] = {n: ost[i][mom].clone() for i, n in enumerate(names)}
            jax_side[mom] = params_from_flax(jax.tree_util.tree_map(
                np.asarray, {k: v for k, v in getattr(adam, mom).items()
                             if isinstance(v, dict)}))
        self.last = {"port": port, "jax": jax_side}
        worst = {what: worst_by_family(port[what], jax_side[what])
                 for what in port}
        worst["updates"] = worst_by_family(
            {k: got[k] - before[k] for k in want_params},
            {k: want_params[k] - want_before[k] for k in want_params})
        return (StepResult(it, m, tm, int(rows.sum()), ties, worst),
                params, opt_state, carry, int(jptr), int(tptr))


def last_tensors(pair: StepPair) -> Dict[str, np.ndarray]:
    """The last iteration's tensors of both packages, float64, keyed
    "<package>|<quantity>|<name>" (for np.savez)."""
    return {f"{pkg}|{what}|{name}": t.detach().double().numpy()
            for pkg, qs in pair.last.items() for what, ts in qs.items()
            for name, t in ts.items()}


def second_look(f32: Dict[str, np.ndarray], f64: Dict[str, np.ndarray]
                ) -> Dict[str, Dict[str, Dict[str, float]]]:
    """Per quantity and family, the worst share of scale (each tensor's
    largest entry in the port's float64 run) of: "port32-jax32" (what the
    float32 check holds), "port32-port64" and "jax32-jax64" (each float32
    program's distance from its own float64 run) and "port64-jax64" (the
    two packages' float64 runs)."""
    pairs = {"port32-jax32": ("port", f32, "jax", f32),
             "port32-port64": ("port", f32, "port", f64),
             "jax32-jax64": ("jax", f32, "jax", f64),
             "port64-jax64": ("port", f64, "jax", f64)}
    out: Dict[str, Dict[str, Dict[str, float]]] = {}
    for key in f64:
        pkg, what, name = key.split("|")
        if pkg != "port":
            continue
        family = name.rsplit(".", 1)[0]
        scale = float(np.abs(f64[key]).max())
        for label, (pa, da, pb, db) in pairs.items():
            diff = float(np.abs(da[f"{pa}|{what}|{name}"]
                                - db[f"{pb}|{what}|{name}"]).max())
            err = diff / scale if scale > 0 else diff
            fam = out.setdefault(what, {}).setdefault(family, {})
            fam[label] = max(fam.get(label, 0.0), err)
    return out
