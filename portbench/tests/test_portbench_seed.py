"""The seed changes the inputs and keeps their shapes; the same seed gives
the same inputs."""

import numpy as np

from portbench import scene

RIG = {"num_cameras": 4, "span_deg": 14.0, "radius": 8.0, "focal_per_width": 1.6}


def _take(seed):
    params = scene.draw_params(np.random.default_rng(seed), RIG["num_cameras"])
    return scene.make_take(RIG, (64, 48), [[0, 1], [2, 3]], params, "cpu")


def test_seed_changes_inputs_not_shapes():
    a, b, a2 = _take(2**31 + 3), _take(2**31 + 4), _take(2**31 + 3)
    for pa, pb, pa2 in zip(a, b, a2):
        for key in ("image0", "image1", "mask0", "mask1", "K0", "Rt0", "K1", "Rt1"):
            va, vb, va2 = getattr(pa, key), getattr(pb, key), getattr(pa2, key)
            assert va.shape == vb.shape
            np.testing.assert_array_equal(va, va2)
        assert not np.array_equal(pa.image0, pb.image0)
        assert not np.array_equal(pa.Rt0, pb.Rt0)
        # the masks cover about as much of the view whatever the seed
        assert abs(pa.mask0.mean() - pb.mask0.mean()) < 0.1 * pa.mask0.mean()
