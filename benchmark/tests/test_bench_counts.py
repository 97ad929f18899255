"""The operation and byte counts of ``flops.py`` against counts by hand at
the maze-lstm and tat-maze-lstm shapes, and against the program's own
layers."""

import json

import pytest
import torch

from benchmark import flops, harness

CFG = {n: json.loads((harness.HERE / "configs" / f"{n}.json").read_text())
       for n in ("tracker-nav", "advat")}
POOL1 = {"num_envs": 4096, "num_steps": 20, "reset_pool": 512,
         "pool_refresh": 1}

# multiply-adds a row, by hand: conv0 7x7 out x 16 x 3x3 x 1; conv1 4x4 x
# 32 x 3x3 x 16; fc 4x4x32 -> 256; LSTM (256 + 128) -> 4 x 128; value and
# policy 128 -> 1 + 4
MAZE_LSTM = [7 * 7 * 16 * 9, 4 * 4 * 32 * 9 * 16, 512 * 256, 384 * 512,
             128 * 5]
# the TAT target: both frames through the convs, fc from 2 x 512, the
# action embedding 4 -> 256 and the reward head 128 -> 1
TAT = [2 * 7 * 7 * 16 * 9, 2 * 4 * 4 * 32 * 9 * 16, 1024 * 256, 384 * 512,
       128 * 5, 4 * 256, 128]


def test_player_macs_by_hand():
    assert [x["macs"] for x in flops.player_layers(CFG["tracker-nav"],
                                                   False)] == MAZE_LSTM
    assert [x["macs"] for x in flops.player_layers(CFG["advat"],
                                                   True)] == TAT
    assert sum(MAZE_LSTM) == 409104 and sum(TAT) == 622112


@pytest.mark.parametrize("name", ["tracker-nav", "advat"])
def test_step_flops_by_hand(name):
    b, t = 4096, 20
    fwd0, fwd1 = sum(MAZE_LSTM), sum(TAT if name == "advat" else MAZE_LSTM)
    # a backward: the weight gradient of every layer, the input gradient of
    # all but conv0 (the observation) and the TAT's action embedding
    bwd0 = 2 * fwd0 - MAZE_LSTM[0]
    bwd1 = 2 * fwd1 - TAT[0] - TAT[5]
    want = 2 * (fwd0 + fwd1) * b * (t + 1) + 2 * bwd0 * b * t
    if name == "advat":
        want += 2 * bwd1 * b * t
    assert flops.step_flops(CFG[name], POOL1) == want


def test_wgrad_counts_by_hand():
    got = flops.wgrad_counts(CFG["tracker-nav"], POOL1)
    b, t = 4096, 20
    assert got == [
        {"flops": 2.0 * 7 * 7 * 16 * 9 * b * t,
         "bytes": 4.0 * t * (b * (13 * 13 + 16 * 7 * 7) + 16 * 9)},
        {"flops": 2.0 * 4 * 4 * 32 * 9 * 16 * b * t,
         "bytes": 4.0 * t * (b * (16 * 7 * 7 + 32 * 4 * 4) + 32 * 16 * 9)}]
    advat = flops.wgrad_counts(CFG["advat"], POOL1)
    assert len(advat) == 4 and advat[:2] == got
    assert advat[2]["flops"] == 2 * got[0]["flops"]


def test_flood_bytes_is_the_kernel_tables_count():
    # 512 rows x 16 goals x 82^2 int16 fields, the mazes and the goals
    assert flops.flood_bytes(512, 16, 82) == (512 * 16 * 82 * 82 * 2
                                              + 512 * 82 * 82 + 512 * 16 * 8)
    assert round(flops.flood_bytes(512, 16, 82) / 1e6, 1) == 113.7


@pytest.mark.parametrize("name", ["tracker-nav", "advat"])
def test_counts_match_the_programs_layers(name):
    """Each player's multiply-adds, counted from the program's own conv
    and dense layers on one forward of a row."""
    from active_tracking_rl_torch.config import NetConfig, parse_env_id
    from active_tracking_rl_torch.models.dueling import build_model
    cfg = CFG[name]
    ncfg = NetConfig.from_name(cfg["network"], aux=cfg["aux"])
    ecfg = parse_env_id(cfg["env_id"])
    model = build_model(ncfg, ecfg.num_actions, ecfg.obs_shape, "cpu")
    macs = {0: 0, 1: 0}

    def hook(player):
        def count(mod, inp, out):
            if isinstance(mod, torch.nn.Conv2d):
                k = mod.kernel_size[0] * mod.kernel_size[1]
                macs[player] += out.numel() * mod.in_channels * k
            elif isinstance(mod, torch.nn.Linear):
                macs[player] += out.numel() * mod.in_features
        return count

    for p in (0, 1):
        for m in getattr(model, f"player{p}").modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
                m.register_forward_hook(hook(p))
    w = cfg["pob_window"]
    obs = torch.zeros((1, 2, 1, w, w, 1))
    hx = torch.zeros((1, 2, cfg["rnn_out"]))
    with torch.no_grad():
        model.step_both(obs, hx, hx, torch.zeros((1, 2, 4)))
    lstm = (cfg["fc_dim"] + cfg["rnn_out"]) * 4 * cfg["rnn_out"]
    for p, tat in ((0, False), (1, cfg["tat"])):
        want = sum(x["macs"] for x in flops.player_layers(cfg, tat))
        assert macs[p] + lstm == want
