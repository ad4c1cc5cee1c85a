"""The port's own copies of the JAX package's small helpers
(``audio_diffusion_torch/utils.py`` against
``audio_diffusion_tpu/utils/__init__.py``): the same values on the same
arguments."""
import pytest

from audio_diffusion_torch import utils as port
from audio_diffusion_tpu import utils as ref

CASES = [
    ("iff", (True, 3)), ("iff", (False, 3)), ("iff", (0, "x")),
    ("is_sequence", ([1],)), ("is_sequence", ((1, 2),)),
    ("is_sequence", ("ab",)), ("is_sequence", (None,)),
    ("to_list", ((1, 2),)), ("to_list", ([3],)), ("to_list", (4,)),
    ("to_list", (None,)),
    ("prefix_dict", ("net_", {"a": 1, 2: "b"})), ("prefix_dict", ("", {})),
]


@pytest.mark.parametrize("name,args", CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(CASES)])
def test_helpers_match_the_jax_package(name, args):
    got, want = getattr(port, name)(*args), getattr(ref, name)(*args)
    assert got == want and type(got) is type(want)
    if name == "to_list" and isinstance(args[0], list):
        assert got is args[0]  # a list passes through, as in the reference
