"""Launch plans of the port's GN kernels (B: ``ops/gn_solve.py``, C:
``ops/gn8_solve.py``) at every level shape of the 1080p similarity path,
the 4K homography path and the tests' 96x128 clips. Pure Python: the plans
are what the wrappers hand the CUDA launch, which runs only on the card."""

import pytest

from video_stabilizer_tpu_torch.config import AlignerParams
from video_stabilizer_tpu_torch.models.aligner import level_specs
from video_stabilizer_tpu_torch.ops import gn8_solve, gn_solve

# (frame width, height, items per launch): the 1080p path (8 streams x
# 16 frames), the 4K path (2 x 16) and the tests' small clips.
PATHS = [(1920, 1080, 128), (3840, 2160, 32), (128, 96, 2), (128, 96, 30)]
CASES = [(module, w, h, items, s.ht * s.wt)
         for module in (gn_solve, gn8_solve)
         for w, h, items in PATHS
         for s in level_specs(w, h, AlignerParams())]


def _id(case):
    module, w, h, items, n = case
    return f"{module.__name__.rsplit('.', 1)[1]}-{w}x{h}-{items}-N{n}"


@pytest.mark.parametrize("case", CASES, ids=[_id(c) for c in CASES])
def test_launch_plan(case):
    module, _, _, items, n = case
    plan = module.launch_plan(items, n)
    # The slices of a cluster cover [0, n) once, in rank order.
    covered = [k for lo, hi in plan.slices() for k in range(lo, hi)]
    assert covered == list(range(n))
    assert plan.slice * plan.cluster >= n
    # A cluster size the launch accepts, one CTA per rank per item.
    assert plan.cluster in gn_solve.CLUSTER_SIZES and plan.cluster <= 8
    assert plan.grid == items * plan.cluster
    assert plan.threads in module.THREADS
    # The cache holds whole keypoints of the slice, within what a block
    # may opt into.
    assert 0 < plan.cached <= plan.slice
    assert plan.smem == plan.cached * 4 * module.CACHE_FLOATS
    assert plan.smem <= gn_solve.SMEM_LIMIT


@pytest.mark.parametrize("module", [gn_solve, gn8_solve])
def test_every_cluster_size_covers_keypoints(module):
    """make_plan at every cluster and block size, on keypoint counts that
    split unevenly and counts smaller than the cluster."""
    for n in (1, 7, 15, 480, 1981, 20736):
        for cluster in gn_solve.CLUSTER_SIZES:
            for threads in module.THREADS:
                plan = gn_solve.make_plan(3, n, cluster, threads,
                                          module.CACHE_FLOATS)
                covered = [k for lo, hi in plan.slices()
                           for k in range(lo, hi)]
                assert covered == list(range(n))
                assert plan.grid == 3 * cluster
                assert plan.smem <= gn_solve.SMEM_LIMIT
    # Not a power of two, or a cluster above the portable 8 CTAs.
    for cluster in (3, 16):
        with pytest.raises(ValueError):
            gn_solve.make_plan(3, 100, cluster, module.THREADS[0],
                               module.CACHE_FLOATS)


def test_level_zero_spreads_over_the_card():
    """At the largest level each path launches more than one CTA per item:
    4K has only 32 items for 132 SMs."""
    assert gn8_solve.launch_plan(32, 20736).grid >= 128
    assert gn_solve.launch_plan(128, 5184).cluster > 1
