"""Device time of one DiT call of a T2V request, by kernel category.

Usage:
  python tools/profile_t2v.py --quant_linear --linear_branch [--root DIR]
  python tools/profile_t2v.py --model Wan2.1-14B --quant_linear --linear_branch

Takes `turbodiffusion_tpu_torch/scripts/time_t2v.py`'s flags and builds its
pipeline, runs its requests (`--requests`, 1 unless given: the warm-up),
then times one DiT call of the request's shape under torch.profiler and
prints `chip_smoke.py`'s phase-4 profile line: the call's wall time, the
device window, the device's idle share and device time by kernel category.
`--root DIR` profiles the package at DIR (another tree unpacked beside this
one) with this checkout's scripts, as `time_t2v.py --root` times it.
"""
import importlib.util
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--requests" not in argv:
        argv += ["--requests", "1"]
    # this checkout's chip_smoke.py and time_t2v.py, whichever package they
    # time (both import it only once time_t2v has put --root on the path)
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    spec = importlib.util.spec_from_file_location(
        "time_t2v", ROOT / "turbodiffusion_tpu_torch" / "scripts" / "time_t2v.py")
    t2v = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(t2v)
    return t2v.main(argv, after=lambda pipe, args: chip_smoke._profile_denoise(
        pipe, args.label, args.resolution))


if __name__ == "__main__":
    sys.exit(main())
