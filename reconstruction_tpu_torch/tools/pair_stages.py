"""Seconds by stage of one warm stereo pair on the card, for one or more
trees of the port: the `myself` preset's pair (1280x1920, `chip_smoke.py`'s
slice scene) and the `dome32` preset's pair (0, 1) (3840x2160, 5 levels).
For each tree and scene:

  wall_s        two warm `match_pair`s, the card synchronized at both ends
  seconds       the stages of a third, the card synchronized around each
                call of the functions `stereo.pipeline` calls by name,
                keyed by pyramid level inside `match_one_level`
                ("L4/ordering_constraint"); "other" is the wall less their sum
  totals        ordering_constraint and propagate_bounds over all levels
  profile       one more pair under torch.profiler: its wall, the card's
                busy time (the device events' durations summed), the device
                events (launches and copies), those named like an
                elementwise kernel and the device-to-host copies (each a
                read-back the host waits for)
  digests       sha256 of the dtype, shape and bytes of what the pair
                carries downstream (`pair_digests`; equal digests: equal
                outputs, bit for bit)

`chip_smoke.py` times, profiles and digests with this module's functions.

Each tree runs in a fresh process, with its own build of the kernels,
in the order given; give two trees as parent, change, change, parent to
compare them on one card in one call:

    python3 reconstruction_tpu_torch/tools/pair_stages.py \\
        --package _archive/parent --package . --package . --package _archive/parent

A tree is a directory holding `reconstruction_tpu_torch/`.  One JSON line
is printed per tree and scene (--json PATH also writes them, a list).
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent.parent
SCENES = ("myself", "dome")

# The functions `stereo.pipeline` calls by name, timed by `pair_stage_seconds`.
PAIR_STAGES = ("rectify_pair", "rectify_map", "remap_bilinear", "erode_mask",
               "build_pyramid", "valid_mask", "find_margin", "brute_force_match",
               "guided_match", "smoothness_constraint", "ordering_constraint",
               "uniqueness_constraint", "propagate_bounds", "rematch", "median_filter",
               "disparity_refine", "_drift", "disparity_to_cloud")


def timed(fn):
    """(result, seconds) of ``fn()``, the card synchronized at both ends."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def pair_stage_seconds(run) -> dict:
    """Seconds by stage of one match_pair ``run``, the card synchronized
    around each call: the functions `stereo.pipeline` calls by name are
    wrapped for the run (not in the package), keyed by pyramid level
    inside `match_one_level` ("L4/ordering_constraint") and by name
    outside it; "other" is the wall less their sum."""
    import torch
    from reconstruction_tpu_torch.stereo import pipeline as sp
    real = {n: getattr(sp, n) for n in PAIR_STAGES + ("match_one_level",)}
    secs, level = {}, [None]

    def synced(name):
        def call(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real[name](*a, **kw)
            torch.cuda.synchronize()
            key = name if level[0] is None else f"L{level[0]}/{name}"
            secs[key] = secs.get(key, 0.0) + time.perf_counter() - t0
            return out
        return call

    def one_level(*a, **kw):
        level[0] = a[5]
        try:
            return real["match_one_level"](*a, **kw)
        finally:
            level[0] = None

    for name in PAIR_STAGES:
        setattr(sp, name, synced(name))
    sp.match_one_level = one_level
    try:
        _, wall = timed(run)
    finally:
        for name, fn in real.items():
            setattr(sp, name, fn)
    secs["other"] = wall - sum(secs.values())
    return dict(wall_s=wall, seconds=dict(sorted(secs.items(), key=lambda kv: -kv[1])))


def stage_totals(seconds: dict) -> dict:
    """ordering_constraint and propagate_bounds seconds summed over levels."""
    return {n: sum(v for k, v in seconds.items() if k.split("/")[-1] == n)
            for n in ("ordering_constraint", "propagate_bounds")}


def digest(a) -> str:
    """sha256 of a tensor's or an array's dtype, shape and bytes (equal
    digests: equal arrays, bit for bit)."""
    a = a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)
    a = np.ascontiguousarray(a)
    return hashlib.sha256(f"{a.dtype}{a.shape}".encode() + a.tobytes()).hexdigest()


def pair_digests(res) -> dict:
    """Digests of what a PairResult carries downstream."""
    return dict(disparity=digest(res.disparity), xyz=digest(res.cloud.xyz),
                colors=digest(res.cloud.colors), valid=digest(res.cloud.valid),
                rect0=digest(res.rect_images[0]), rect1=digest(res.rect_images[1]),
                mask0=digest(res.rect_masks[0]), mask1=digest(res.rect_masks[1]),
                em0=digest(res.rect_masks_eroded[0]), drift=digest(res.refine_drift),
                margins0=[int(v) for v in res.margins0])


def device_events(run, attempts: int = 3) -> list:
    """The device events of torch.profiler (CPU and CUDA activity) over
    ``run``, as (name, start_us, us) records read raw
    (`utils/profiling.cuda_activity`, held against `prof.events()` once a
    process).  The profiler on the card's machine now and then records no
    device event in a session; such a session is run again."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from reconstruction_tpu_torch.utils.profiling import cuda_activity
    event = collections.namedtuple("DeviceEvent", "name start_us us")
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        events = [event(e.name(), e.start_ns() / 1e3, e.duration_ns() / 1e3)
                  for e in cuda_activity(prof)]
        if events:
            return events
    raise AssertionError(f"the profiler recorded no device event in {attempts} sessions")


def profile_pair(run) -> dict:
    """The card's busy time and device events of one ``run``; ``by_name``
    holds each kernel's (ms, launches)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    events = device_events(run)
    wall = time.perf_counter() - t0
    by_name = {}
    for e in events:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.us / 1e3, n + 1)
    return dict(wall_ms=wall * 1e3, busy_ms=sum(e.us for e in events) / 1e3,
                events=len(events),
                elementwise=sum("elementwise" in e.name for e in events),
                dtoh=sum("DtoH" in e.name for e in events), by_name=by_name)


def scene_args(scene: str):
    """match_pair's positional arguments for ``scene``."""
    import numpy as np

    from reconstruction_tpu_torch.config import preset
    if scene == "myself":
        from reconstruction_tpu_torch.utils.synthetic import make_stereo_scene
        cfg = preset("myself")
        cams, imgs, masks = make_stereo_scene(image_size=cfg.finest_size, span_deg=7.0,
                                              device="cuda")
        return (cfg, imgs[0], imgs[1], masks[0], masks[1], cams[0].K, cams[0].Rt,
                cams[1].K, cams[1].Rt)
    from reconstruction_tpu_torch.tools import demo_dome
    cfg = preset("dome32")
    _, pairs = demo_dome.dome_pairs(cfg, "cuda")
    p = pairs[0]
    return (cfg, p.image0, p.image1, p.mask0, p.mask1, np.asarray(p.K0),
            np.asarray(p.Rt0), np.asarray(p.K1), np.asarray(p.Rt1))


def run_tree(package: str) -> list:
    """The measurements of SCENES in this process, whose
    `reconstruction_tpu_torch` is imported from ``package``."""
    sys.path[0] = str(Path(package).resolve())     # in place of this script's directory
    import torch

    import reconstruction_tpu_torch
    from reconstruction_tpu_torch.stereo.pipeline import match_pair
    from reconstruction_tpu_torch.utils.profiling import card_line
    if not torch.cuda.is_available():
        raise SystemExit("pair_stages: needs a CUDA device")
    out = []
    for scene in SCENES:
        args = scene_args(scene)
        run = lambda: match_pair(*args, device="cuda")
        res, first = timed(run)
        walls = [timed(run)[1] for _ in range(2)]
        stages = pair_stage_seconds(run)
        prof = profile_pair(run)
        del prof["by_name"]
        out.append(dict(
            package=package, imported=str(Path(reconstruction_tpu_torch.__file__).parent),
            scene=scene, card=card_line(), first_s=first, wall_s=walls,
            stage_wall_s=stages["wall_s"], totals=stage_totals(stages["seconds"]),
            seconds=stages["seconds"], profile=prof, digests=pair_digests(res)))
        print(json.dumps(out[-1]), flush=True)
        del res, args
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", action="append", default=None,
                    help="a tree holding reconstruction_tpu_torch/ (repeatable; "
                         "default: this checkout)")
    ap.add_argument("--json", default=None, help="also write the lines here")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.child:
        run_tree(a.child)
        return 0
    lines = []
    for pkg in a.package or [str(ROOT)]:
        proc = subprocess.run([sys.executable, __file__, "--child", pkg],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr[-4000:])
            raise SystemExit(f"pair_stages: the tree {pkg} failed")
        for line in proc.stdout.splitlines():
            if line.startswith("{"):
                print(line, flush=True)
                lines.append(json.loads(line))
    if a.json:
        with open(a.json, "w") as f:
            json.dump(lines, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
