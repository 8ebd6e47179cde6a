"""The last of the JAX package's public names on the port, against the JAX
functions on seeded numpy inputs: `core/camera.CameraPair`,
`load_calibration` and `relative_pose`, `core/morphology.erode_mask_np`
and `stereo/triangulate.disparity_to_cloud_np` (the last two are numpy in
both packages; the port keeps its own copies).  Everything is exact but
`relative_pose`, whose 3x3 products XLA and numpy's BLAS may sum in
another order: within 1e-6, a few float32 ulps of entries of size <= 4."""

import numpy as np
import pytest

from numpy.testing import assert_array_equal

from reconstruction_tpu.config import NOMATCH
from reconstruction_tpu.core import camera as jcam
from reconstruction_tpu.core import morphology as jmorph
from reconstruction_tpu.stereo import triangulate as jtri
from reconstruction_tpu_torch.core import camera as tcam
from reconstruction_tpu_torch.core import morphology as tmorph
from reconstruction_tpu_torch.stereo import triangulate as ttri


def _rotation(rng) -> np.ndarray:
    q, r = np.linalg.qr(rng.normal(size=(3, 3)))
    return q * np.sign(np.diag(r))


def _calib(rng, ids) -> dict:
    calib = {}
    for cid in ids:
        K = np.array([[800 + rng.uniform(-50, 50), 0, 320 + rng.normal()],
                      [0, 800 + rng.uniform(-50, 50), 240 + rng.normal()],
                      [0, 0, 1]])
        Rt = np.concatenate([_rotation(rng), rng.normal(size=(3, 1))], axis=1)
        calib[f"intrinsic-{cid}"] = K.reshape(-1)      # as the YAML parser gives them
        calib[f"extrinsic-{cid}"] = Rt.reshape(-1)
    return calib


def test_load_calibration_exact():
    ids = [0, 2, 5]
    calib = _calib(np.random.default_rng(0), ids)
    want = jcam.load_calibration(calib, ids)
    got = tcam.load_calibration(calib, ids)
    assert list(got) == list(want)
    for cid in ids:
        assert got[cid].K.dtype == np.float32 and got[cid].Rt.dtype == np.float32
        assert_array_equal(got[cid].K, np.asarray(want[cid].K))
        assert_array_equal(got[cid].Rt, np.asarray(want[cid].Rt))


@pytest.mark.parametrize("seed", range(4))
def test_relative_pose(seed):
    ids = [0, 1]
    calib = _calib(np.random.default_rng(seed), ids)
    j, t = jcam.load_calibration(calib, ids), tcam.load_calibration(calib, ids)
    Rj, Tj = jcam.relative_pose(j[0], j[1])
    Rt_, Tt = tcam.relative_pose(t[0], t[1])
    assert Rt_.dtype == np.float32 and Tt.dtype == np.float32
    np.testing.assert_allclose(Rt_, np.asarray(Rj), rtol=0, atol=1e-6)
    np.testing.assert_allclose(Tt, np.asarray(Tj), rtol=0, atol=1e-6)
    # x1 = R x0 + T: a world point seen from both cameras
    x = np.array([0.3, -0.2, 4.0], np.float32)
    x0 = t[0].R @ x + t[0].t
    np.testing.assert_allclose(Rt_ @ x0 + Tt, t[1].R @ x + t[1].t, atol=1e-5)


def test_camera_pair_fields():
    calib = _calib(np.random.default_rng(1), [3, 4])
    j, t = jcam.load_calibration(calib, [3, 4]), tcam.load_calibration(calib, [3, 4])
    kw = dict(left_id=3, right_id=4, left_image="a.png", right_image="b.png",
              left_mask="ma.png")
    jp = jcam.CameraPair(left=j[3], right=j[4], **kw)
    tp = tcam.CameraPair(left=t[3], right=t[4], **kw)
    for name in ("left_id", "right_id", "left_image", "right_image", "left_mask",
                 "right_mask"):
        assert getattr(tp, name) == getattr(jp, name)
    for side in ("left", "right"):
        assert_array_equal(getattr(tp, side).Rt, np.asarray(getattr(jp, side).Rt))
    with pytest.raises(AttributeError):
        tp.left_id = 5       # frozen, as the reference's


@pytest.mark.parametrize("se", [1, 3, 4, 7])
def test_erode_mask_np_exact(se):
    rng = np.random.default_rng(se)
    mask = np.where(rng.uniform(size=(40, 52)) < 0.9, 255.0, 0.0).astype(np.float32)
    mask[rng.uniform(size=mask.shape) < 0.05] = 254.0     # just under the threshold
    got = tmorph.erode_mask_np(mask, se)
    assert got.dtype == bool
    assert_array_equal(got, jmorph.erode_mask_np(mask, se))
    assert_array_equal(tmorph.erode_mask_np(mask, se, threshold=200.0),
                       jmorph.erode_mask_np(mask, se, threshold=200.0))


@pytest.mark.parametrize("H, W, scale", [(60, 80, 1.0), (120, 96, 0.5)])
def test_disparity_to_cloud_np_exact(H, W, scale):
    rng = np.random.default_rng(H)
    disp = rng.uniform(-30, -5, (H, W)).astype(np.float32)
    disp[rng.uniform(size=(H, W)) < 0.2] = NOMATCH
    mask = np.zeros((H, W), np.uint8)
    mask[5:-5, 6:-6] = 255
    mask[rng.uniform(size=(H, W)) < 0.02] = 0
    image = rng.integers(0, 256, (H, W, 3)).astype(np.uint8)
    Q = np.array([[1, 0, 0, -W / 2], [0, 1, 0, -H / 2], [0, 0, 0, 700.0],
                  [0, 0, -1 / 0.12, 0.3]])
    R, T = _rotation(rng), rng.normal(size=3)
    margins = np.array([4, H - 6, 7, W - 9])
    want = jtri.disparity_to_cloud_np(disp, mask, image, Q, R, T, margins, scale)
    got = ttri.disparity_to_cloud_np(disp, mask, image, Q, R, T, margins, scale)
    for name in ("xyz", "colors", "valid"):
        assert_array_equal(getattr(got, name), np.asarray(getattr(want, name)))
    assert 0 < got.valid.sum() < H * W
