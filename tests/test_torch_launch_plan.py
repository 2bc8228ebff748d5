"""The port's launch plan against the reference's geometry: for every shape
of the reference kernel tests and 2,000 seeded configs of the paper space,
the plan's blocks cover every output element, and its block indices equal
the reference's ``split_grid`` / ``clamped_index`` index maps."""

import numpy as np
import pytest

from repro.core.space import paper_space
from repro.kernels import common as ref_common
from repro_torch.kernels.common import geometry_from_config, launch_plan

SHAPES = [(64, 128), (128, 256), (96, 384), (40, 128), (56, 200), (50, 130), (8, 130)]
N_CONFIGS = 2000


def _configs():
    space = paper_space(constrained=False)
    return space.sample_batch(np.random.default_rng(20220328), N_CONFIGS)


@pytest.mark.parametrize("shape", SHAPES)
def test_launch_plan_covers_and_matches_reference_index_maps(shape):
    x, y = shape
    for cfg in _configs():
        g = geometry_from_config(cfg)
        plan = launch_plan(g, x, y)
        gx, gy = plan.grid

        # the reference's grid and clamped index maps, evaluated on all
        # grid indices at once (its clamped_index traces as jnp ops)
        steps_r, nblk_r = ref_common.split_grid(x, g.rows_step, g.wx)
        steps_c, nblk_c = ref_common.split_grid(y, g.bn, g.wy)
        assert (gx, gy) == (g.wx * steps_r, g.wy * steps_c)
        gi, gj = np.arange(gx), np.arange(gy)
        ref_r = np.asarray(ref_common.clamped_index(gi // steps_r, gi % steps_r, steps_r, nblk_r))
        ref_c = np.asarray(ref_common.clamped_index(gj // steps_c, gj % steps_c, steps_c, nblk_c))
        assert [plan.row_block(i) for i in gi] == ref_r.tolist()
        assert [plan.col_block(j) for j in gj] == ref_c.tolist()

        covered = np.zeros((x, y), dtype=bool)
        for r0, c0 in plan.origins():
            assert 0 <= r0 < x and 0 <= c0 < y
            covered[r0 : r0 + plan.rows, c0 : c0 + plan.cols] = True
        assert covered.all(), (shape, cfg)


def test_launch_plan_geometry_is_the_reference_geometry():
    for cfg in _configs()[:200]:
        ours = geometry_from_config(cfg)
        ref = ref_common.geometry_from_config(cfg)
        assert (ours.bm, ours.bn, ours.tz, ours.wx, ours.wy, ours.wz) == (
            ref.bm, ref.bn, ref.tz, ref.wx, ref.wy, ref.wz)
        assert ours.rows_step == ref.rows_step
