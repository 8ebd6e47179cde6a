"""Port vs reference: the OpenCV-YAML reader and writer and the image files.

The port parses OpenCV's FileStorage YAML itself; the reference goes
through PyYAML.  Both read files written by either package's
`save_opencv_yaml` and OpenCV-style text to equal values and dtypes.
Images go through Pillow in both packages: the port's pixels are
bit-equal to the reference's, and without Pillow a call raises.
"""

import sys

import numpy as np
import pytest

import torch_parity  # noqa: F401  (few intra-op threads a worker)

from reconstruction_tpu.io import images as jimages
from reconstruction_tpu.io import opencv_yaml as jyaml
from reconstruction_tpu_torch.io import images as timages
from reconstruction_tpu_torch.io import opencv_yaml as tyaml

RUN_CONFIG = {
    "filepath": "D:/data/take 1/",
    "outfilename": "out/1.ply",
    "isoutput": 0,
    "camera_calib_name": "calib_camera.yml",
    "PyrmNum": 4,
    "LowestLevelWidth": 160,
    "mls_radius": 2.5,
    "imagelist": ["0001_Cam0.jpg", "0001_Cam1.jpg", "0001_Cam2.jpg"],
    "masklist": ["mask/0001_Cam0.jpg"],
    "camID": np.asarray([[0, 1], [2, 3], [4, 5], [7, 6]], np.int32),
    "camU8": np.asarray([[0, 1], [7, 6]], np.uint8),
    "intrinsic-0": np.asarray([[1600.5, 0, 640.25], [0, 1600.5, 960.75], [0, 0, 1]]),
    "extrinsic-0": np.random.default_rng(3).normal(size=(3, 4)),
    "dist": np.asarray([[0.1, -2.5e-07, 3e12]], np.float32),
    "shorts": np.asarray([[-3, 7, 32767]], np.int16),
    "column": np.asarray([1.5, 2.5, 3.5]),
}

# As OpenCV's FileStorage writes it: e notation, a bare '0.', a matrix whose
# data runs over three lines, float and uint8 matrices, a flow list.
OPENCV_TEXT = """%YAML:1.0
---
intrinsic-3: !!opencv-matrix
   rows: 3
   cols: 3
   dt: d
   data: [ 1.6000000000000000e+03, 0., 6.3950000000000000e+02, 0.,
       1.6000000000000000e+03, 9.5950000000000000e+02, 0., 0.,
       1. ]
R1t_times_R-1234: !!opencv-matrix
   rows: 4
   cols: 3
   dt: f
   data: [ 9.99999940e-01, -3.45678902e-04, 1.23456789e-02,
       3.45000011e-04, 1.00000000e+00, -2.5e-05, -1.23456791e-02,
       2.5e-05, 9.99923825e-01, 1.5e+02, -2.25e+01, 3.75e+02 ]
camID: !!opencv-matrix
   rows: 2
   cols: 2
   dt: u
   data: [ 0, 1, 7, 6 ]
PyrmNum: 4
scale: 1.25e+00
filepath: "C:/captures/"
kinect_sn:
   - "001122"
   - "003344"
boundingbox: [ 0, 512, 0, 424 ]
"""


def _same(a, b, key):
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, (key, a.dtype, b)
        assert a.shape == b.shape and np.array_equal(a, b, equal_nan=True), key
    else:
        assert type(a) is type(b) and a == b, (key, a, b)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_yaml_reads_written_files_like_the_reference(tmp_path, writer):
    path = str(tmp_path / "cfg.yml")
    (jyaml if writer == "reference" else tyaml).save_opencv_yaml(path, RUN_CONFIG)
    ref, got = jyaml.load_opencv_yaml(path), tyaml.load_opencv_yaml(path)
    assert list(ref) == list(got) == list(RUN_CONFIG)
    for key in ref:
        _same(ref[key], got[key], key)


def test_yaml_writers_are_equal(tmp_path):
    a, b = tmp_path / "a.yml", tmp_path / "b.yml"
    jyaml.save_opencv_yaml(str(a), RUN_CONFIG)
    tyaml.save_opencv_yaml(str(b), RUN_CONFIG)
    assert a.read_bytes() == b.read_bytes()


def test_yaml_reads_opencv_text_like_the_reference(tmp_path):
    path = tmp_path / "calib.yml"
    path.write_text(OPENCV_TEXT)
    ref, got = jyaml.load_opencv_yaml(str(path)), tyaml.load_opencv_yaml(str(path))
    assert list(ref) == list(got)
    for key in ref:
        _same(ref[key], got[key], key)
    assert got["R1t_times_R-1234"].dtype == np.float32
    assert got["camID"].dtype == np.uint8 and got["camID"].tolist() == [[0, 1], [7, 6]]
    assert got["intrinsic-3"][1, 2] == 959.5


def test_yaml_reads_nan_and_inf_as_opencv_writes_them(tmp_path):
    """OpenCV writes non-finite values as .Nan and .Inf (PyYAML resolves
    .Inf but not .Nan, so the reference's reader fails on such a file)."""
    path = tmp_path / "nan.yml"
    path.write_text("%YAML:1.0\n---\nm: !!opencv-matrix\n   rows: 1\n   cols: 4\n"
                    "   dt: d\n   data: [ .Nan, .Inf, -.Inf, -1.5e-03 ]\nv: .Nan\n")
    got = tyaml.load_opencv_yaml(str(path))
    m = got["m"]
    assert np.isnan(m[0, 0]) and m[0, 1] == np.inf and m[0, 2] == -np.inf
    assert m[0, 3] == -1.5e-03 and np.isnan(got["v"])


@pytest.mark.parametrize("text, line", [
    ("a: 1\nb:\n   c: 2\n", 3),                                    # nested mapping
    ("m: !!opencv-matrix\n   rows: 1\n   cols: 1\n   dt: \"3d\"\n   data: [ 1 ]\n", 1),
    ("m: !!opencv-matrix\n   rows: 2\n   cols: 2\n   dt: i\n   data: [ 1, 2, 3 ]\n", 1),
    ("m: !!opencv-matrix\n   rows: 1\n   cols: 2\n   data: [ 1,\n   2\n", 4),
    ("flag: true\n", 1),
    ("a: 1\na: 2\n", 2),
])
def test_yaml_rejects_what_it_does_not_parse(tmp_path, text, line):
    path = tmp_path / "bad.yml"
    path.write_text(text)
    with pytest.raises(ValueError, match=f"bad.yml:{line}:"):
        tyaml.load_opencv_yaml(str(path))


def _pixels(rng, shape):
    """Random pixels on a smooth ramp (float32, on the uint8 grid, BGR when
    colour)."""
    yy, xx = np.mgrid[:shape[0], :shape[1]]
    ramp = (3 * yy + 5 * xx) % 256
    if len(shape) == 3:
        ramp = ramp[..., None]
    noise = rng.integers(0, 32, shape)
    return ((ramp + noise) % 256).astype(np.float32)


@pytest.mark.parametrize("shape", [(37, 53), (37, 53, 3)])
@pytest.mark.parametrize("grayscale", [False, True])
def test_png_written_by_the_reference_reads_bit_equal(tmp_path, rng, shape, grayscale):
    img = _pixels(rng, shape)
    path = str(tmp_path / "ref.png")
    jimages.imwrite(path, img)
    ref = jimages.imread(path, grayscale=grayscale)
    got = timages.imread(path, grayscale=grayscale)
    assert got.dtype == ref.dtype == np.float32 and got.shape == ref.shape
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("shape", [(37, 53), (37, 53, 3)])
def test_png_written_by_the_port_reads_bit_equal(tmp_path, rng, shape):
    img = _pixels(rng, shape) + 0.7          # truncated to uint8, as the reference
    path = str(tmp_path / "port.png")
    timages.imwrite(path, img)
    for gray in (False, True):
        assert np.array_equal(timages.imread(path, grayscale=gray),
                              jimages.imread(path, grayscale=gray))
    # The same pixels as the reference's own writer gives.
    jimages.imwrite(str(tmp_path / "ref.png"), img)
    assert np.array_equal(timages.imread(path), jimages.imread(str(tmp_path / "ref.png")))


def test_format_comes_from_the_contents(tmp_path, rng):
    img = _pixels(rng, (20, 24, 3))
    png = tmp_path / "a.png"
    timages.imwrite(str(png), img)
    jpg = tmp_path / "0001_Cam0.jpg"
    jpg.write_bytes(png.read_bytes())
    assert np.array_equal(timages.imread(str(jpg)), img)
    assert np.array_equal(timages.imread(str(jpg)), jimages.imread(str(jpg)))


def test_jpeg_goes_through_pillow(tmp_path, rng):
    img = _pixels(rng, (24, 32, 3))
    path = str(tmp_path / "x.jpg")
    timages.imwrite(path, img)
    assert open(path, "rb").read(2) == b"\xff\xd8"
    assert np.array_equal(timages.imread(path), jimages.imread(path))
    assert np.array_equal(timages.imread(path, grayscale=True),
                          jimages.imread(path, grayscale=True))


def test_images_need_pillow(tmp_path, rng, monkeypatch):
    img = _pixels(rng, (8, 8, 3))
    png = str(tmp_path / "x.png")
    timages.imwrite(png, img)
    monkeypatch.setitem(sys.modules, "PIL", None)      # Pillow not installed
    with pytest.raises(ImportError, match="Pillow") as e:
        timages.imread(png)
    assert "x.png" in str(e.value)
    with pytest.raises(ImportError, match="y.jpg"):
        timages.imwrite(str(tmp_path / "y.jpg"), img)
    with pytest.raises(ImportError, match="Pillow"):
        timages.check_writable(str(tmp_path / "y.png"))
