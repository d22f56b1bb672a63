"""The port's streaming coarse pass at 1, 3 and 8 grouped survivors
against the JAX package's streaming Pallas kernel (_stream_call, interpret
mode on CPU): tests/test_torch_survivors.py's tiled comparison for
``kernel="streaming"``, with its tolerances."""

import pytest

from test_torch_survivors import ARMS, SURVIVOR_COUNTS, check_against_pallas


@pytest.mark.parametrize("arm", ARMS)
@pytest.mark.parametrize("survivors", SURVIVOR_COUNTS)
@pytest.mark.parametrize("tile_n", [512, 1024])
@pytest.mark.parametrize("dim", [100, 200])       # Dp 128 and 256
def test_plain_streaming_matches_pallas_at_survivors(arm, survivors, tile_n,
                                                     dim):
    check_against_pallas(arm, "streaming", survivors, tile_n, dim)
