"""K2's scratch layout: which of a world's rows lie in the thread block's
shared memory and which in the world-major global buffer
(``ops/megastep.py:scratch_layout``), and the header's offsets, for every
committed world K2 takes. CPU only: builds nothing."""

import numpy as np
import pytest

from flygym_tpu_torch import load_compiled
from flygym_tpu_torch.compose.bridge import ASSETS
from flygym_tpu_torch.ops import megastep as ms

# Every committed world K2 takes: the shared/global split of its scratch.
WORLD_ASSETS = ["benchmark_fly", "env_fly", "terrain_fly", "twofly", "twofly_full", "threefly",
                "strict_fly", "muscle_fly", "mixed_fly"]


@pytest.mark.parametrize("name", WORLD_ASSETS)
def test_scratch_layout_covers_every_row_once(name):
    """K2's scratch layout (``scratch_layout``) for each committed world:
    its slots tile the rows in order; within a slot each side's regions lie
    end to end, so a row belongs to one slot and to at most one region of
    each side (the two sides of a slot share rows: the dynamics' body
    arrays and the Newton loop's rows, live at different times of a step);
    every region lies wholly in shared or in global memory; the shared
    region fits the 227 KB a block may use; and the header's offsets and
    sizes are the layout's."""
    model = load_compiled(ASSETS / f"{name}.npz").model
    layout = ms.scratch_layout(model)
    header, n_scratch = ms.model_header(model)
    n, n_shared = layout["n_scratch"], layout["n_shared"]
    assert n == n_scratch and layout["n_global"] == n - n_shared
    assert 4 * n_shared <= ms.SHARED_LIMIT == 227 * 1024
    slots_of_row = np.zeros(n, int)
    regions = {}
    end = 0
    for off, size, sides in layout["slots"]:
        assert off == end
        slots_of_row[off : off + size] += 1
        assert n_shared <= off or off + size <= n_shared
        for side in sides:
            row = off
            for region, r_off, r_size in side:
                assert r_off == row and region not in regions
                regions[region] = (r_off, r_size)
                row += r_size
            assert row <= off + size
        assert max(sum(r[2] for r in side) for side in sides) == size
        end = off + size
    assert end == n and (slots_of_row == 1).all()
    for region, (r_off, _size) in regions.items():
        assert f"constexpr int {region} = {r_off};" in header, region
    for key, value in (("N_SCRATCH", n), ("N_SHARED", n_shared), ("N_GLOBAL", n - n_shared),
                       ("THREADS", layout["threads"])):
        assert f"constexpr int {key} = {value};" in header, key
