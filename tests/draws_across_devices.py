"""The trainer CLI with its random draws made on another device than its
arithmetic: a diagnostic that parts the draws from the numerics.

``python tests/draws_across_devices.py --draws cpu -- <run/train.py flags,
--device cuda>`` trains on the card with every draw of ``ops/noise.py``
(uniforms, Gumbel and normal noise, integers, permutations) computed on
the CPU and moved to the card; ``--draws cuda -- ... --device cpu`` the
reverse. The generator (threefry2x32) gives the same bits on both devices,
so this moves only the transforms of those bits (the logs of the Gumbel
noise, ``erfinv``), which may differ in the last ulp. Nothing in the port
changes: this script patches it in its own process only. The modes that
moved ``torch.Generator`` streams between devices are in ``git show
f8e7a8b:tests/draws_across_devices.py``.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

# run as a script from anywhere: the repository root holds the port
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def draws_on(device: str) -> None:
    """Every ops/noise.py draw computed on `device`, then moved."""
    from active_tracking_rl_torch.ops import noise

    def moved(fn):
        def draw(*args, **kw):
            names = fn.__code__.co_varnames[:fn.__code__.co_argcount]
            i = names.index("device")
            if i < len(args):
                target = args[i]
                args = args[:i] + (device,) + args[i + 1:]
            else:
                target = kw.get("device")
                kw["device"] = device
            out = fn(*args, **kw)
            gen = args[names.index("generator")] if names.index(
                "generator") < len(args) else kw["generator"]
            return out.to(gen.device if target is None else target)
        return draw

    for name in ("uniform", "gumbel", "normal", "randint", "permutations"):
        setattr(noise, name, moved(getattr(noise, name)))


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    split = argv.index("--") if "--" in argv else len(argv)
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--draws", choices=("cpu", "cuda"), default=None)
    args = ap.parse_args(argv[:split])
    train_argv = argv[split + 1:]
    if args.draws is not None:
        draws_on(args.draws)
    from active_tracking_rl_torch.run import train
    train.main(train_argv)


if __name__ == "__main__":
    main()
