"""Operations and bytes that a training step needs, counted from the
configuration's shapes: the yardstick of the utilization and roofline
metrics.

A multiply-add is two operations; only the convolutions and the dense
products count (bias adds, activations and the cell's gates are left out).
A forward runs for every player at every rollout step and once more for
the bootstrap value; a backward, for the trained players only, at every
step: the weight gradient of every layer, and the input gradient of every
layer but those whose input needs none (the first convolution, whose input
is the observation, and the TAT's embedding of the one-hot action).
Remat's recomputed forwards are not counted: the step requires them only
to save memory.
"""

from __future__ import annotations

from typing import Dict, List

F32 = 4


def conv_layers(cfg: dict, frames: int) -> List[dict]:
    """The encoder's convolutions of one player over its `frames` frames:
    each with its input and output sides and its multiply-adds a row."""
    out, cin, side = [], 1, cfg["pob_window"]
    k, stride = cfg["conv_kernel"], cfg["conv_stride"]
    pad = k // 2
    for cout in cfg["conv_channels"]:
        side_out = (side + 2 * pad - k) // stride + 1
        out.append({"cin": cin, "cout": cout, "k": k, "side_in": side,
                    "side_out": side_out, "frames": frames,
                    "macs": frames * side_out ** 2 * cout * cin * k * k})
        cin, side = cout, side_out
    return out


def player_layers(cfg: dict, tat: bool) -> List[dict]:
    """Every product of one player a row: name, multiply-adds, and whether
    its input takes a gradient."""
    frames = (2 if tat else 1) * cfg["stack_frames"]
    convs = conv_layers(cfg, frames)
    layers = [{"name": f"conv{i}", "macs": c["macs"], "dgrad": i > 0}
              for i, c in enumerate(convs)]
    last = convs[-1]
    feat = frames * last["side_out"] ** 2 * last["cout"]
    fc, hidden, a = cfg["fc_dim"], cfg["rnn_out"], cfg["num_actions"]
    layers += [{"name": "fc", "macs": feat * fc, "dgrad": True},
               {"name": "lstm", "macs": (fc + hidden) * 4 * hidden,
                "dgrad": True},
               {"name": "heads", "macs": hidden * (1 + a), "dgrad": True}]
    if tat:
        layers += [{"name": "fc_action_tracker", "macs": a * fc,
                    "dgrad": False},
                   {"name": "reward_aux", "macs": hidden, "dgrad": True}]
    return layers


def players(cfg: dict) -> List[dict]:
    """Both players: whether each is TAT and whether it trains."""
    mode = cfg["train_mode"]
    return [{"tat": False, "trained": mode in (0, -1, 2)},
            {"tat": cfg["tat"], "trained": mode in (1, -1, 2)}]


def step_flops(cfg: dict, traffic: dict) -> float:
    """Model operations of one iteration."""
    rows, steps = traffic["num_envs"], traffic["num_steps"]
    total = 0.0
    for pl in players(cfg):
        layers = player_layers(cfg, pl["tat"])
        fwd = sum(x["macs"] for x in layers)
        total += 2 * fwd * rows * (steps + 1)
        if pl["trained"]:
            bwd = sum(x["macs"] * (2 if x["dgrad"] else 1) for x in layers)
            total += 2 * bwd * rows * steps
    return total


def wgrad_counts(cfg: dict, traffic: dict) -> List[Dict[str, float]]:
    """Each trained convolution's weight gradient over one iteration: its operations and bytes (the layer's input and its
    output's gradient read once, the weight gradient written once, at each
    rollout step)."""
    rows = traffic["num_envs"]
    steps = traffic["num_steps"]
    out = []
    for pl in players(cfg):
        if not pl["trained"]:
            continue
        frames = (2 if pl["tat"] else 1) * cfg["stack_frames"]
        for c in conv_layers(cfg, frames):
            n = rows * c["frames"]
            read = n * (c["cin"] * c["side_in"] ** 2
                        + c["cout"] * c["side_out"] ** 2)
            write = c["cout"] * c["cin"] * c["k"] ** 2
            out.append({"flops": 2.0 * c["macs"] * rows * steps,
                        "bytes": float(F32 * (read + write) * steps)})
    return out


def flood_bytes(rows: int, goals: int, side: int) -> float:
    """One BFS launch: the mazes (a byte a cell) and goals (two int32 a
    goal) read once, the int16 distance fields written once."""
    cells = side * side
    return float(rows * cells + rows * goals * 2 * 4
                 + rows * goals * cells * 2)
