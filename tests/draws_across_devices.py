"""The trainer CLI with its random draws made on another device than its
arithmetic: a diagnostic that parts the card's draws from the card's
numerics.

``python tests/draws_across_devices.py --draws cpu -- <run/train.py flags,
--device cuda>`` trains on the card with every draw made by CPU
generators (the draws of ``--device cpu`` at the same seed, bit for bit:
parameters, reset draws, pool windows, Gumbel noise) and moved to the
card; ``--draws cuda -- ... --device cpu`` trains on the CPU with the
card's draws. Every ``torch.Generator`` that run/train.py makes is made
on the ``--draws`` device; ``ops/noise.py``'s draws and the plain
``torch.rand``, ``torch.randint`` and ``Tensor.uniform_`` calls of
``envs/`` and ``models/init.py`` are computed there (Gumbel transform and
permutation sort included) and then moved. ``--only pool`` moves only
the pool windows' generators (``run/train.py:iteration_generator``) there,
``--only actions`` only the Gumbel noise of the train steps, and ``--only
init`` only the initial parameters and env carry (each from a generator
of its own on that device, seeded with the run's ``--seed``), or a
comma-separated list of these; the rest is drawn where the run computes. Nothing in the port changes:
this script patches it in its own process only.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import types

import torch

# run as a script from anywhere: the repository root holds the port
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def patch(draws: str, only: str, seed: int) -> None:
    from active_tracking_rl_torch.ops import noise
    from active_tracking_rl_torch.rl import learner
    from active_tracking_rl_torch.run import train

    generator_cls, rand, randint_, uniform_ = (
        torch.Generator, torch.rand, torch.randint, torch.Tensor.uniform_)
    gumbel, randint, permutations = (noise.gumbel, noise.randint,
                                     noise.permutations)

    def make_generator(device=None):
        return generator_cls(device=draws)

    def rand_on(*size, generator=None, device=None, **kw):
        if generator is None or device is None:
            return rand(*size, generator=generator, device=device, **kw)
        return rand(*size, generator=generator, device=generator.device,
                    **kw).to(device)

    def randint_on(*args, generator=None, device=None, **kw):
        if generator is None or device is None:
            return randint_(*args, generator=generator, device=device, **kw)
        return randint_(*args, generator=generator, device=generator.device,
                        **kw).to(device)

    def uniform_on(self, a=0.0, b=1.0, *, generator=None):
        if generator is None or generator.device == self.device:
            return uniform_(self, a, b, generator=generator)
        tmp = torch.empty(self.shape, dtype=self.dtype,
                          device=generator.device)
        uniform_(tmp, a, b, generator=generator)
        with torch.no_grad():
            return self.copy_(tmp)

    parts = only.split(",")
    if "all" in parts:
        # the trainer's generators (its own, the pool windows', the
        # evals'), through a copy of the torch namespace that train.py
        # alone reads
        train.torch = types.SimpleNamespace(**vars(torch))
        train.torch.Generator = make_generator
    if "pool" in parts:
        window = train.iteration_generator
        train.iteration_generator = lambda base, it, device: window(
            base, it, draws)
    if "init" in parts:
        init_learner = train.init_learner

        def init_on(model, env, net_cfg, tcfg, generator, mesh):
            state = init_learner(model, env, net_cfg, tcfg,
                                 generator_cls(device=draws).manual_seed(seed),
                                 mesh)
            state.carry.generator = generator
            return state

        train.init_learner = init_on
    if "actions" in parts:
        step_noise = learner.draw_step_noise
        own = generator_cls(device=draws).manual_seed(seed)
        learner.draw_step_noise = lambda t, n, a, generator, device: \
            learner.StepNoise(*(x.to(device) for x in step_noise(
                t, n, a, own, draws)))
    torch.rand = rand_on
    torch.randint = randint_on
    torch.Tensor.uniform_ = uniform_on
    noise.gumbel = lambda shape, generator, device: gumbel(
        shape, generator, generator.device).to(device)
    noise.randint = lambda high, shape, generator, device, dtype=torch.int64: \
        randint(high, shape, generator, generator.device, dtype).to(device)
    noise.permutations = lambda n_rows, n, generator, device: permutations(
        n_rows, n, generator, generator.device).to(device)


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    split = argv.index("--") if "--" in argv else len(argv)
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--draws", choices=("cpu", "cuda"), required=True)
    ap.add_argument("--only", default="all",
                    help="all, or a comma-separated list of pool, actions "
                    "and init")
    args = ap.parse_args(argv[:split])
    train_argv = argv[split + 1:]
    seed = (int(train_argv[train_argv.index("--seed") + 1])
            if "--seed" in train_argv else 1)
    patch(args.draws, args.only, seed)
    from active_tracking_rl_torch.run import train
    train.main(train_argv)


if __name__ == "__main__":
    main()
