"""The three CUDA flood launchers against their plain twins on the card,
also at the caps of the bit-parallel BFS kernel (csrc/flood_bfs.cu) behind
flood_sweep, flood_sweep16 and flood_relax; one train step of the K=16
Nav recipe at its batch (1024 envs, 20 steps, a pool of 256, remat on as
the trainer CLI trains) on the card against the CPU, every gradient and
every updated parameter, the CPU taking the card's relu decisions where
the two take one apart (chip_smoke.py:check_update); the draws that
ops/noise.py's generator (threefry2x32) makes on the card, equal to the
CPU's bit for bit (each device's Gumbel noise within
chip_smoke.GUMBEL_ULP ulp of float64's transform of the same bits), at
production's shapes (chip_smoke.py:check_draws); and those draws held to
the CPU's laws (which tests/test_torch_draw_laws.py holds to JAX's).

This file imports neither JAX nor the JAX package, so it runs on a machine
with a card and PyTorch alone (the suite's conftest.py needs JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Without a card each test skips itself. chip_smoke.py makes the same checks
at the main paths' shapes.
"""

import numpy as np
import pytest
import torch

from active_tracking_rl_torch import config as tconfig
from active_tracking_rl_torch.envs import maps
from active_tracking_rl_torch.envs.env import TrackEnv
from active_tracking_rl_torch.models.heads import sample_discrete
from active_tracking_rl_torch.ops import flood, noise
from active_tracking_rl_torch.utils.platform import pin_float32
# tests/ is on the path under pytest
from torch_mazes import perfect_maze
from torch_stats import OFFSET_CATS, chi2_2samp_ok, counts, ks_2samp_ok

ENV_IDS = ["Track2D-BlockPartialNav-v0", "Track2D-BlockPartialNav-v1",
           "Track2D-EmptyPartialNav-v0", "Track2D-MazePartialNav-v0",
           "Track2D-MazePartialNav-v1"]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this check there")
    return torch.device("cuda")


def _inputs(env_id, rows, g, dev):
    """Maps of the id's family from the port's generator, g free goals per
    row with (-1,-1) pads on every third row and a wall goal on the next."""
    cfg = tconfig.parse_env_id(env_id)
    gen = noise.generator(len(env_id), dev)
    mz = maps.generate_map(cfg, maps.draw_map(cfg, rows, gen, dev))
    s = cfg.maze_size
    goals = maps.sample_free_cells(noise.uniform((rows, s * s), gen, dev),
                                   mz, g)
    goals[::3, -2:] = -1
    goals[1::3, 0] = 0
    return mz.contiguous(), goals.contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("env_id", ENV_IDS)
def test_kernels_match_twins_on_the_card(env_id):
    dev = _card()
    for g in (16, 13, 4):
        mz, goals = _inputs(env_id, 24, g, dev)
        for iters in (20, 48, 256):
            outs = {}
            for variant in flood.VARIANTS:
                kernel = flood.KERNELS[variant]
                before = kernel.launches
                outs[variant] = flood.flood_fields(mz, goals, iters, variant)
                assert kernel.launches == before + 1
                want = flood.PLAIN[variant](mz, goals, iters)
                torch.testing.assert_close(outs[variant], want, rtol=0, atol=0)
            assert torch.equal(outs["sweep16"], outs["sweep"])


def _check_all(mz, goals, iters):
    outs = {}
    for variant in flood.VARIANTS:
        outs[variant] = flood.flood_fields(mz, goals, iters, variant)
        want = flood.PLAIN[variant](mz, goals, iters)
        torch.testing.assert_close(outs[variant], want, rtol=0, atol=0,
                                   msg=f"{variant} at iters {iters}")
    assert torch.equal(outs["sweep16"], outs["sweep"])


@pytest.mark.cuda
@pytest.mark.parametrize("iters", [0, 1, 15, 16, 17, 255, 256])
def test_kernels_match_twins_at_the_caps_on_the_card(iters):
    """Perfect 81^2 mazes: paths far longer than 256, so every cap binds.
    Odd S and an odd count of rows put the fields' bases on every 2-byte
    offset modulo 16."""
    dev = _card()
    rng = np.random.RandomState(5)
    mz = torch.from_numpy(np.stack([perfect_maze(81, rng)
                                    for _ in range(5)])).to(dev)
    goals = maps.sample_free_cells(
        noise.uniform((5, 81 * 81), noise.generator(iters, dev), dev), mz, 7)
    goals[0, -1] = -1
    goals[1, 0] = 0
    _check_all(mz, goals.contiguous(), iters)


@pytest.mark.cuda
@pytest.mark.parametrize("side", [1, 24, 33, 64, 97, 128])
def test_kernels_match_twins_at_every_word_count_on_the_card(side):
    """Sides with 1 to 4 words a row, up to the BFS kernel's largest."""
    dev = _card()
    rng = np.random.RandomState(side)
    mz = torch.from_numpy((rng.rand(6, side, side) < 0.25)
                          .astype(np.uint8)).to(dev)
    goals = torch.from_numpy(rng.randint(-1, side + 1, (6, 9, 2))
                             .astype(np.int32)).to(dev)
    for iters in (0, 17, 256):
        _check_all(mz, goals, iters)


@pytest.mark.cuda
@pytest.mark.parametrize("side", [24, 82, 128])
def test_sweep16_matches_twin_at_the_caps_on_the_card(side):
    """flood_sweep16 alone, through its own launcher and count, bit for bit
    against its twin at every cap, on perfect mazes (closed by a wall row
    and column at even sides), whose paths outrun the caps."""
    dev = _card()
    rng = np.random.RandomState(side)
    odd = side - 1 + side % 2
    mz = np.ones((4, side, side), np.uint8)
    for i in range(4):
        mz[i, :odd, :odd] = perfect_maze(odd, rng)
    mz = torch.from_numpy(mz).to(dev)
    goals = maps.sample_free_cells(
        noise.uniform((4, side * side), noise.generator(side, dev), dev),
        mz, 5)
    goals[0, -1] = -1
    goals = goals.contiguous()
    for iters in (0, 1, 15, 16, 17, 255, 256):
        before = flood.FLOOD_SWEEP16.launches
        got = flood.flood_fields(mz, goals, iters, "sweep16")
        assert flood.FLOOD_SWEEP16.launches == before + 1
        torch.testing.assert_close(got, flood.PLAIN["sweep16"](mz, goals,
                                                               iters),
                                   rtol=0, atol=0, msg=f"iters {iters}")


@pytest.mark.cuda
def test_relax_kernel_runs_whole_chunks_on_the_card():
    """iters 20 runs 32 sweeps: finite distances up to 32 on an open grid."""
    dev = _card()
    mz = torch.zeros((1, 24, 24), dtype=torch.uint8, device=dev)
    goals = torch.tensor([[[0, 0], [23, 23]]], dtype=torch.int32, device=dev)
    relax = flood.flood_fields(mz, goals, 20, "relax")
    sweep = flood.flood_fields(mz, goals, 20, "sweep")
    assert int(relax[relax < flood.INF].max()) == 32
    assert int(sweep[sweep < flood.INF].max()) == 20


@pytest.mark.cuda
def test_kernels_refuse_bad_inputs_on_the_card():
    dev = _card()
    mz = torch.zeros((2, 82, 82), dtype=torch.uint8, device=dev)
    goals = torch.zeros((2, 3, 2), dtype=torch.int32, device=dev)
    for kernel in flood.KERNELS.values():
        with pytest.raises(TypeError):
            kernel(mz.int(), goals, 48)
        with pytest.raises(ValueError):
            kernel(mz[:, :, :81], goals, 48)
        with pytest.raises(ValueError):
            kernel(torch.zeros((1, 200, 200), dtype=torch.uint8, device=dev),
                   goals[:1], 48)


@pytest.mark.cuda
@pytest.mark.parametrize("low_entropy", [False, True])
def test_update_matches_cpu_at_the_recipe_batch(low_entropy):
    """From a fresh model, and from one whose tracker's policy head is
    scaled until its first-step entropy is below 0.05: the loss and every
    gradient to 1e-4 of its tensor's largest entry, every updated
    parameter to 1e-4 of its layer's (chip_smoke.py's reference phase
    makes the check at 256 envs)."""
    _card()
    import chip_smoke   # the repository root is on the path under pytest
    pin_float32()
    res = chip_smoke.check_update(torch, chip_smoke.RECIPE_ENVS,
                                  chip_smoke.RECIPE_POOL,
                                  noise.generator(0),
                                  low_entropy=low_entropy)
    print(chip_smoke.update_text(res))


@pytest.mark.cuda
@pytest.mark.parametrize("logits", [(0.0, -4.0, -8.0, -12.0),
                                    (0.0, -6.0, -10.0, -10.0)])
def test_card_action_draws_follow_the_cpu_law(logits):
    """sample_discrete's actions at saturated logits under Gumbel noise
    drawn by ops/noise.py on the card and on the CPU: one law (chi-square
    over 2^22 draws a side)."""
    _card()
    n, a = 1 << 22, len(logits)
    got = {}
    for dev in ("cuda", "cpu"):
        g = noise.gumbel((n, a), noise.generator(4, dev), dev)
        x = torch.tensor(logits, device=dev).expand(n, a)
        got[dev] = torch.bincount(sample_discrete(x, g).action,
                                  minlength=a).cpu().numpy()
    ok, stat, crit = chi2_2samp_ok(got["cuda"], got["cpu"])
    assert ok, f"chi2 {stat:.1f} > {crit:.1f}: {got}"


@pytest.mark.cuda
def test_card_reset_draws_follow_the_cpu_law():
    """Resets of Track2D-BlockPartialNav-v0 at the recipe's sizes drawn on
    the card and on the CPU: the interior wall fraction (KS), the target's
    spawn offset (chi-square) and each Nav tape's share of each action
    (KS; 256 tapes on the card, 64 on the CPU)."""
    _card()
    cfg = tconfig.parse_env_id("Track2D-BlockPartialNav-v0")
    walls, offsets, shares = {}, {}, {}
    for dev, tapes in (("cuda", 256), ("cpu", 64)):
        gen = noise.generator(9, dev)
        mz = maps.generate_map(cfg, maps.draw_map(cfg, 1024, gen, dev))
        walls[dev] = mz[:, 1:-1, 1:-1].float().mean((1, 2)).cpu().numpy()
        pos, _ = maps.sample_spawns(cfg, mz, maps.draw_spawns(cfg, 1024, gen,
                                                              dev))
        offsets[dev] = counts([tuple(o) for o in
                               (pos[:, 1] - pos[:, 0]).tolist()],
                              OFFSET_CATS)
        state, _ = TrackEnv(cfg, dev).reset_batch(tapes, gen)
        tape = state.tape.cpu().numpy()
        shares[dev] = np.stack([(tape == k).mean(1)
                                for k in range(cfg.num_actions)], 1)
    ok, d, crit = ks_2samp_ok(walls["cuda"], walls["cpu"])
    assert ok, f"wall fraction KS {d:.4f} > {crit:.4f}"
    assert offsets["cuda"][1] == 0 and offsets["cpu"][1] == 0
    ok, stat, crit = chi2_2samp_ok(offsets["cuda"][0], offsets["cpu"][0])
    assert ok, f"spawn offset chi2 {stat:.1f} > {crit:.1f}: {offsets}"
    for k in range(cfg.num_actions):
        ok, d, crit = ks_2samp_ok(shares["cuda"][:, k], shares["cpu"][:, k])
        assert ok, f"tape action {k} share KS {d:.4f} > {crit:.4f}"


@pytest.mark.cuda
def test_card_window_generators_draw_apart():
    """run/train.py's pool windows and evals key a generator by (seed,
    iteration): each window's draws on the card differ from the others'."""
    _card()
    from active_tracking_rl_torch.run.train import POOL_SEED, \
        iteration_generator
    draws = [noise.uniform((4096,), iteration_generator(1 + POOL_SEED, w,
                                                        "cuda"), "cuda")
             for w in (1, 17, 33, 49)]
    for i in range(len(draws)):
        for j in range(i):
            assert not torch.equal(draws[i], draws[j]), (i, j)
            r = torch.corrcoef(torch.stack([draws[i], draws[j]]))[0, 1]
            assert abs(float(r)) < 0.1, (i, j, float(r))


@pytest.mark.cuda
def test_card_draws_equal_the_cpus():
    """ops/noise.py's bits, uniforms, integers and permutations drawn on the
    card equal the CPU's bit for bit, and its Gumbel noise on either device
    lies within chip_smoke.GUMBEL_ULP ulp of max(|g|, 1) of float64's
    -log(-log u) of the same u; so do the draws of one K=16
    Nav train step at the recipe's batch and of one 256-row Nav pool."""
    _card()
    import chip_smoke
    tally = chip_smoke.check_draws(torch)
    print(tally)
    assert tally["values"] > 0
