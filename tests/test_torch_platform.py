"""The port's ``utils/platform.py`` against the JAX package's.

``parse_flag`` equals JAX's on the cases of tests/test_platform.py and on
hypothesis-generated argvs (both argparse spellings, prefixes, missing and
malformed values). ``resolve_device`` never hands back the CPU for CUDA:
without a card it raises.
"""

import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from active_tracking_rl_tpu.utils.platform import parse_flag as j_parse_flag
from active_tracking_rl_torch.utils.platform import (default_backend,
                                                     parse_flag,
                                                     resolve_device)

CASES = [
    (["prog", "--local-devices", "8"], "--local-devices", int),
    (["prog", "--local-devices=8"], "--local-devices", int),
    (["prog", "--coordinator=host:1234"], "--coordinator", str),
    (["prog"], "--local-devices", int),
    (["prog", "--local-devices", "x"], "--local-devices", int),
    (["prog", "--local-devices=x"], "--local-devices", int),
    (["prog", "--local-devices"], "--local-devices", int),
    (["prog", "--local-devices-extra", "4"], "--local-devices", int),
    (["prog", "--num-processes", "2", "--num-processes", "3"],
     "--num-processes", int),
]


@pytest.mark.parametrize("argv,name,cast", CASES)
def test_parse_flag_matches_jax_on_its_cases(argv, name, cast):
    assert parse_flag(argv, name, cast) == j_parse_flag(argv, name, cast)


FLAGS = ["--local-devices", "--num-processes", "--process-id",
         "--coordinator"]
TOKENS = st.one_of(
    st.sampled_from(FLAGS + [f + "-extra" for f in FLAGS] + ["-x", "8", "x",
                                                             "", "="]),
    st.builds(lambda f, v: f"{f}={v}", st.sampled_from(FLAGS),
              st.one_of(st.integers(-5, 99).map(str), st.text(max_size=4))),
    st.integers(-3, 300).map(str),
    st.text(max_size=6))


@settings(max_examples=300, deadline=None)
@given(argv=st.lists(TOKENS, max_size=8), name=st.sampled_from(FLAGS),
       as_int=st.booleans())
def test_parse_flag_matches_jax_on_generated_argvs(argv, name, as_int):
    cast = int if as_int else str
    argv = ["prog"] + argv
    assert parse_flag(argv, name, cast) == j_parse_flag(argv, name, cast)


def test_resolve_device_never_gives_the_cpu_for_cuda(monkeypatch):
    assert resolve_device("cpu", 3) == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device is visible"):
        resolve_device("cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert resolve_device("cuda", 3) == torch.device("cuda", 1)
    assert resolve_device("cuda:1", 0) == torch.device("cuda", 1)
    with pytest.raises(RuntimeError, match="only 2 CUDA device"):
        resolve_device("cuda:2")
    assert (default_backend("cuda:0"), default_backend("cpu")) == ("nccl",
                                                                   "gloo")
