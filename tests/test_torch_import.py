"""The PyTorch port stands without JAX: nothing in its import graph, and no
source file in it, imports jax or the JAX package; the card smoke script
refuses to run without a card."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "reconstruction_tpu_torch"


def _run(code: str, cwd=ROOT, timeout=120):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_port_import_graph_has_no_jax():
    proc = _run(
        "import sys\n"
        "import reconstruction_tpu_torch.stereo.pipeline\n"
        "import reconstruction_tpu_torch.utils.synthetic\n"
        "import reconstruction_tpu_torch.utils.convert\n"
        "import reconstruction_tpu_torch.ops.ncc_sweep\n"
        "import reconstruction_tpu_torch.ops.refine\n"
        "import reconstruction_tpu_torch.ops.ba_coupling\n"
        "import reconstruction_tpu_torch.ops.ncc_sweep_mxu\n"
        "import reconstruction_tpu_torch.ops.constraints\n"
        "import reconstruction_tpu_torch.tools.pair_stages\n"
        "import reconstruction_tpu_torch.ba\n"
        "import reconstruction_tpu_torch.stereo.ncc\n"
        "import reconstruction_tpu_torch.ops._build\n"
        "import reconstruction_tpu_torch.config\n"
        "import reconstruction_tpu_torch.pipeline.reconstruct\n"
        "import reconstruction_tpu_torch.pipeline.scan_mesh\n"
        "import reconstruction_tpu_torch.cloud.dedup\n"
        "import reconstruction_tpu_torch.cloud.filters\n"
        "import reconstruction_tpu_torch.cloud.mls\n"
        "import reconstruction_tpu_torch.cloud.normals\n"
        "import reconstruction_tpu_torch.surface.marching\n"
        "import reconstruction_tpu_torch.surface.mesh\n"
        "import reconstruction_tpu_torch.surface.poisson\n"
        "import reconstruction_tpu_torch.surface.texture\n"
        "import reconstruction_tpu_torch.io.ply\n"
        "import reconstruction_tpu_torch.io.images\n"
        "import reconstruction_tpu_torch.native\n"
        "import reconstruction_tpu_torch.__main__\n"
        "import reconstruction_tpu_torch.io.opencv_yaml\n"
        "import reconstruction_tpu_torch.pipeline.batch\n"
        "import reconstruction_tpu_torch.pipeline.kinect\n"
        "import reconstruction_tpu_torch.pipeline.segmentation\n"
        "import reconstruction_tpu_torch.pipeline.video\n"
        "import reconstruction_tpu_torch.surface.simplify\n"
        "import reconstruction_tpu_torch.utils.metrics\n"
        "import reconstruction_tpu_torch.utils.watchdog\n"
        "import reconstruction_tpu_torch.utils.profiling\n"
        "import reconstruction_tpu_torch.parallel\n"
        "import reconstruction_tpu_torch.parallel.mesh\n"
        "import reconstruction_tpu_torch.parallel.multihost\n"
        "import reconstruction_tpu_torch.parallel.launch\n"
        "import reconstruction_tpu_torch.parallel.fusion\n"
        "import reconstruction_tpu_torch.parallel.distributed_ba\n"
        "import reconstruction_tpu_torch.parallel.sharded\n"
        "import reconstruction_tpu_torch.parallel.poisson_sharded\n"
        "import reconstruction_tpu_torch.parallel.production\n"
        "import reconstruction_tpu_torch.parallel.dryrun\n"
        "import reconstruction_tpu_torch.tools.demo_dome\n"
        "import reconstruction_tpu_torch.bench\n"
        "import reconstruction_tpu_torch.tools.demo_video\n"
        "import reconstruction_tpu_torch.tools.bench_scaling\n"
        "import reconstruction_tpu_torch.tools.k67_phase_clocks\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'reconstruction_tpu', 'yaml', 'bench'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_no_source_file_imports_jax():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        for line in f.read_text().splitlines():
            s = line.strip()
            assert not (s.startswith("import jax") or s.startswith("from jax")
                        or s.startswith("import bench") or s.startswith("from bench ")
                        or "import reconstruction_tpu." in s
                        or "from reconstruction_tpu." in s
                        or "from reconstruction_tpu import" in s), (f, line)


def test_match_pair_runs_on_the_card_by_default():
    import inspect
    from reconstruction_tpu_torch.stereo.pipeline import match_pair
    assert inspect.signature(match_pair).parameters["device"].default == "cuda"


def test_reconstruct_runs_on_the_card_by_default():
    import inspect
    from reconstruction_tpu_torch.pipeline.reconstruct import reconstruct
    assert inspect.signature(reconstruct).parameters["device"].default == "cuda"


def test_sharded_cli_no_longer_raises(tmp_path, capsys):
    """`--sharded` reaches the config like a plain run (the multi-device
    layer is ported): a missing config is refused as the reference does."""
    from reconstruction_tpu_torch.__main__ import main
    missing = str(tmp_path / "nope.yml")
    assert main(["prog", missing, "--sharded"], device="cpu") == -1
    assert capsys.readouterr().out == f"Can't open file: {missing}\n"


def test_sharded_reconstruct_needs_the_card_by_default():
    """With a mesh and the device left at its default (the card),
    `reconstruct` refuses a CPU mesh rather than run on the CPU."""
    from reconstruction_tpu_torch.config import preset
    from reconstruction_tpu_torch.parallel.launch import run_local
    sys.path.insert(0, str(ROOT / "tests"))
    import torch_parallel_work
    (err,) = run_local(torch_parallel_work.default_device_error, 1, "cpu",
                       preset("tiny"), [], timeout=120)
    assert "'cuda'" in err and "'cpu'" in err


NEW_ENTRY_POINTS = [
    ("reconstruction_tpu_torch.__main__", "main"),
    ("reconstruction_tpu_torch.pipeline.batch", "run_batch"),
    ("reconstruction_tpu_torch.pipeline.kinect", "kinect_to_cloud"),
    ("reconstruction_tpu_torch.pipeline.segmentation", "cut_image_dir"),
    ("reconstruction_tpu_torch.pipeline.segmentation", "segment_frame"),
    ("reconstruction_tpu_torch.pipeline.video", "reconstruct_video"),
    ("reconstruction_tpu_torch.pipeline.video", "_estimate_relative_pose"),
    ("reconstruction_tpu_torch.utils.metrics", "point_to_mesh_distance"),
    ("reconstruction_tpu_torch.utils.metrics", "chamfer_distance"),
    ("reconstruction_tpu_torch.utils.profiling", "resolve_chip"),
    ("reconstruction_tpu_torch.parallel.mesh", "make_mesh"),
    ("reconstruction_tpu_torch.parallel.multihost", "initialize_distributed"),
    ("reconstruction_tpu_torch.parallel.multihost", "make_pod_mesh"),
    ("reconstruction_tpu_torch.parallel.dryrun", "dryrun"),
    ("reconstruction_tpu_torch.parallel.launch", "run_local"),
    ("reconstruction_tpu_torch.tools.demo_dome", "main"),
    ("reconstruction_tpu_torch.tools.demo_dome", "run_dome"),
    ("reconstruction_tpu_torch.tools.demo_dome", "dome_pairs"),
    ("reconstruction_tpu_torch.tools.demo_dome", "reconstruct_sharded"),
    ("reconstruction_tpu_torch.bench", "main"),
    ("reconstruction_tpu_torch.bench", "run_phase"),
    ("reconstruction_tpu_torch.bench", "measure_kernels"),
    ("reconstruction_tpu_torch.bench", "run_full"),
    ("reconstruction_tpu_torch.bench", "run_stereo_only"),
    ("reconstruction_tpu_torch.bench", "build_rig"),
    ("reconstruction_tpu_torch.tools.demo_video", "main"),
    ("reconstruction_tpu_torch.tools.demo_video", "run_video"),
    ("reconstruction_tpu_torch.tools.bench_scaling", "main"),
    ("reconstruction_tpu_torch.tools.bench_scaling", "run_axis"),
    ("reconstruction_tpu_torch.tools.bench_scaling", "reference_digests"),
]


@pytest.mark.parametrize("module, name", NEW_ENTRY_POINTS)
def test_new_entry_point_runs_on_the_card_by_default(module, name):
    import importlib
    import inspect
    fn = getattr(importlib.import_module(module), name)
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_no_module_reads_yaml_through_pyyaml():
    for f in sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]:
        for line in f.read_text().splitlines():
            s = line.strip()
            assert not (s.startswith("import yaml") or s.startswith("from yaml")), (f, line)


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Without CUDA the script exits non-zero and prints no result; alone
    in a directory (without the package) it fails too."""
    if _run("import torch; print(torch.cuda.is_available())").stdout.strip() == "True":
        return  # a card is present: the refusal cannot be shown here
    proc = _run("import runpy; runpy.run_path('chip_smoke.py', run_name='__main__')")
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    proc = _run("import runpy; runpy.run_path('chip_smoke.py', run_name='__main__')",
                cwd=tmp_path)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
